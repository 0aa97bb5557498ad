"""The launch plans of the port's three kernels, on the CPU.

``cur_matmul.plan``, ``flash_attention.plan`` and ``paged_attention.plan``
are plain functions of the shape that the wrappers launch with;
``work_items`` and ``kv_tiles`` mirror the sources' tile walks, and the
paged plan's entries per split give its table runs. Held here over the
JAX suite's case grids (tests/test_kernels.py,
tests/test_paged_attention.py), the card-only
grids (tests/test_torch_gpu.py) and the main path's shapes
(chip_smoke.py): every output tile and table entry is covered exactly
once, pass 1's splits partition m, shapes TMA cannot describe take the
one-pass body, shared memory fits, and the workspace matches its
formula."""
import itertools

import pytest
import torch

from repro_torch.kernels.cur_matmul import cur_matmul as cm
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.paged_attention import paged_attention as pa

_CUR_CASES = [
    (256, 128, 32, 256), (128, 256, 64, 512), (512, 64, 16, 128),
    (96, 100, 24, 200), (64, 512, 512, 64), (1, 128, 16, 128),
    (2048, 4096, 256, 4096), (2048, 4096, 256, 1024),
    (2048, 4096, 256, 14336),                  # wq, wk, w_gate at r_max 256
    (2048, 4096, 16, 4096), (2048, 4096, 24, 4096), (2048, 4096, 512, 1024),
    (1024, 1000, 64, 512),                     # split edge off a slice edge
    (8 * 1024, 4096, 256, 14336),              # serving prefill, 8 x 1024
]
_SMEM_LIMIT = 232_448                          # bytes a block may use


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("M,m,rk,n", _CUR_CASES)
def test_cur_matmul_plan_routes_by_shape(M, m, rk, n):
    p = cm.plan(M, m, rk, n, torch.bfloat16)
    tma = m % 8 == 0 and rk % 8 == 0 and n % 8 == 0
    assert p.body == ("tc" if tma else "fused")
    assert cm.plan(M, m, rk, n, torch.bfloat16, aligned=False).body == "fused"
    f32 = cm.plan(M, m, rk, n, torch.float32)
    assert f32 == cm.Plan("fused", (_cdiv(M, cm.FUSED_BM),), 1, 0)
    if not tma:
        assert p == f32


@pytest.mark.parametrize("M,m,rk,n", [c for c in _CUR_CASES
                                      if cm.tc_shape_ok(*c[1:])])
def test_cur_matmul_tc_tiles_cover_each_output_once(M, m, rk, n):
    p = cm.plan(M, m, rk, n, torch.bfloat16)
    grid1, grid2, grid_r = p.grid
    # pass 1 (t = x @ CU): a (row tile, column tile) item per split
    N, K, splits = rk, m, p.splits
    items = cm.work_items(M, N, K, splits)
    tiles_m, tiles_n = _cdiv(M, cm.TC_BM), _cdiv(N, cm.TC_BN)
    # the tiles span the output and no tile lies wholly outside it
    assert (tiles_m - 1) * cm.TC_BM < M <= tiles_m * cm.TC_BM
    assert (tiles_n - 1) * cm.TC_BN < N <= tiles_n * cm.TC_BN
    seen = {}
    for mt, nt, s, kb, ke in items:
        assert 0 <= mt < tiles_m and 0 <= nt < tiles_n
        seen.setdefault((mt, nt), []).append((s, kb, ke))
    assert set(seen) == set(itertools.product(range(tiles_m),
                                              range(tiles_n)))
    kt = _cdiv(K, cm.TC_BK)
    assert (kt - 1) * cm.TC_BK < K <= kt * cm.TC_BK
    for ranges in seen.values():
        # each tile once per split; the splits partition the slices
        assert sorted(s for s, _, _ in ranges) == list(range(splits))
        edges = [kb for _, kb, _ in sorted(ranges)] + [kt]
        assert edges[0] == 0 and all(
            a < b for a, b in zip(edges, edges[1:]))
        assert [ke for _, _, ke in sorted(ranges)] == edges[1:]
    # the persistent blocks take disjoint strides that cover every item
    assert 1 <= grid1 <= cm.SMS
    taken = sorted(i for b in range(grid1)
                   for i in range(b, len(items), grid1))
    assert taken == list(range(len(items)))
    assert 1 <= p.splits <= min(_cdiv(m, cm.TC_BK), cm.MAX_SPLITS)
    assert grid_r >= 1
    # pass 2: each block owns one row tile and a stride of column tiles;
    # together they take every output tile once
    tiles_m, tiles_n = _cdiv(M, cm.TC_BM), _cdiv(n, cm.TC_BN)
    assert (tiles_n - 1) * cm.TC_BN < n <= tiles_n * cm.TC_BN
    assert grid2 % tiles_m == 0 and grid2 // tiles_m <= tiles_n
    assert grid2 <= max(cm.SMS, tiles_m)
    tiles = [t for b in range(grid2) for t in cm.pass2_tiles(M, n, b, grid2)]
    assert sorted(tiles) == list(itertools.product(range(tiles_m),
                                                   range(tiles_n)))
    # all of a block's rows of t fit beside the ring (r <= 512)
    assert _cdiv(rk, cm.TC_BK) <= 8


def test_cur_matmul_main_shape_splits_fill_the_card():
    # 32 output tiles of 128 x 128 at M 2048, r 256: four splits of m
    p = cm.plan(2048, 4096, 256, 14336, torch.bfloat16)
    assert p.splits == 4 and p.grid[:2] == (128, 128)
    assert cm.plan(8192, 4096, 256, 14336, torch.bfloat16).splits == 1
    # a split boundary that is not a multiple of the slice still falls on
    # a slice edge, and the last, ragged slice is zero-filled by TMA
    p = cm.plan(1024, 1000, 64, 512, torch.bfloat16)
    assert p.splits == 16 and 1000 % (p.splits * cm.TC_BK) != 0


@pytest.mark.parametrize("M,m,rk,n", _CUR_CASES)
def test_cur_matmul_workspace_matches_formula(M, m, rk, n):
    p = cm.plan(M, m, rk, n, torch.bfloat16)
    want = (4 * p.splits * M * rk + 2 * M * rk) if p.body == "tc" else 0
    assert p.workspace_bytes == want


@pytest.mark.parametrize("m,rk,n", [(100, 24, 200), (128, 20, 128),
                                    (128, 16, 100), (130, 16, 128),
                                    (4096, 255, 4096)])
def test_cur_matmul_untileable_shapes_take_the_fused_body(m, rk, n):
    assert not cm.tc_shape_ok(m, rk, n)
    assert cm.plan(256, m, rk, n, torch.bfloat16).body == "fused"


_FLASH_CASES = [  # B, H, K, S, d, window, causal
    (1, 4, 2, 128, 32, 0, True), (2, 4, 4, 64, 16, 0, True),
    (1, 8, 1, 128, 32, 0, True), (1, 4, 2, 128, 32, 48, True),
    (1, 2, 2, 64, 64, 16, True), (1, 4, 2, 100, 16, 0, True),
    (1, 4, 2, 72, 16, 0, False), (1, 4, 2, 130, 128, 0, True),
    (1, 4, 2, 200, 64, 0, False), (4, 32, 8, 512, 128, 0, True),
    (2, 32, 8, 512, 128, 128, True), (1, 8, 2, 1024, 64, 0, True),
    (1, 4, 2, 1024, 64, 100, False),
    (4, 4, 1, 1024, 256, 512, True), (1, 4, 1, 100, 256, 0, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,d,win,causal", _FLASH_CASES)
def test_flash_plan_covers_every_query_row(B, H, K, S, d, win, causal,
                                           dtype):
    p = fa.plan(B, H, S, d, dtype)
    if dtype == torch.bfloat16:   # wgmma and TMA for d 64 and 128
        assert p.body == ("wg" if d in (64, 128) else "mma")
        assert fa.plan(B, H, S, d, dtype, aligned=False).body == "mma"
        assert fa.BQ == 16 * p.threads // 32    # a warp per 16 query rows
    else:
        assert p.body == "fma"
    assert p.grid[1:] == (H, B) and p.threads == 128
    assert (p.grid[0] - 1) * fa.BQ < S <= p.grid[0] * fa.BQ
    assert p.smem_bytes <= _SMEM_LIMIT


@pytest.mark.parametrize("B,H,K,S,d,win,causal", _FLASH_CASES)
def test_flash_kv_tiles_hold_every_live_key(B, H, K, S, d, win, causal):
    """The visited tiles hold every key a row of the block attends to, and
    the skipped ones hold none."""
    nk = _cdiv(S, fa.BKV)
    for q0 in range(0, S, fa.BQ):
        tiles = fa.kv_tiles(q0, S, causal, win)
        assert tiles.step == 1 and len(tiles) >= 1
        for j in range(nk):
            live = False
            for qi in range(q0, min(q0 + fa.BQ, S)):
                for kj in range(j * fa.BKV, min((j + 1) * fa.BKV, S)):
                    ok = (not causal or kj <= qi) and (
                        win <= 0 or kj > qi - win)
                    live = live or ok
            if live:
                assert j in tiles, (q0, j)
            elif j not in tiles:
                continue
            else:   # a visited tile without a live pair: only at the edges
                assert j in (tiles.start, tiles.stop - 1), (q0, j)


@pytest.mark.parametrize("d", [d for d in fa.HEAD_DIMS if d <= 128])
def test_flash_plan_shared_memory_fits_two_blocks_per_sm(d):
    # the bf16 bodies' K/V rings and q tile leave room for two blocks per SM
    for aligned in (True, False):
        p = fa.plan(1, 1, 64, d, torch.bfloat16, aligned=aligned)
        assert 2 * p.smem_bytes <= _SMEM_LIMIT


def test_flash_plan_at_head_dim_256_fits_one_block():
    """d 256 (gemma3): the mma body's q tile and two K/V stages (165 KB)
    and the f32 body's tiles (210 KB) fit one block's 227 KB; bf16 never
    takes the wg body there."""
    for aligned in (True, False):
        p = fa.plan(4, 4, 1024, 256, torch.bfloat16, aligned=aligned)
        assert p.body == "mma" and p.smem_bytes == 168_960
    p = fa.plan(4, 4, 1024, 256, torch.float32)
    assert p.body == "fma" and p.smem_bytes == 214_784
    assert p.smem_bytes <= _SMEM_LIMIT


_SMEM_PER_SM = 233_472                         # an SM's shared memory
_PAGED_SERVING = (8, 8, 4, 128, 16, 69)        # B, K, G, r, bs, maxb


@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_paged_splits_cover_every_entry_once(bs):
    for maxb in range(1, 129):
        for B, K, G in ((1, 1, 4), (2, 2, 2), (8, 8, 4), (64, 8, 4)):
            p = pa.plan(B, K, G, 128, bs, maxb, torch.bfloat16)
            e = p.entries_per_split     # split s: entries [s e, (s + 1) e)
            runs = [(s * e, min((s + 1) * e, maxb)) for s in range(p.splits)]
            assert len(runs) == p.splits >= 1
            assert p.grid == (B * K, p.splits)
            # contiguous, non-empty, in order, together [0, maxb)
            assert runs[0][0] == 0 and runs[-1][1] == maxb
            assert all(a < b for a, b in runs)
            assert all(x[1] == y[0] for x, y in zip(runs, runs[1:]))
            assert max(b - a for a, b in runs) == p.entries_per_split
            assert p.entries_per_split <= pa.MAX_ENTRIES
            # a split covers at least a stage's worth of tokens, unless
            # the whole table is one split
            if p.splits > 1:
                assert p.entries_per_split * bs >= pa.MIN_SPLIT_TOKENS
                assert B * K * p.splits <= (
                    pa.blocks_per_sm(p.smem_bytes) * pa.SMS)


def test_paged_serving_shape_fills_the_card():
    B, K, G, r, bs, maxb = _PAGED_SERVING
    # one wave: two blocks per SM at r 128 (a 104 KB ring), three at r 64
    for rank, per_sm, splits, eps in ((128, 2, 4, 18), (64, 3, 6, 12)):
        p = pa.plan(B, K, G, rank, bs, maxb, torch.bfloat16)
        assert p.body == "mma"
        assert pa.blocks_per_sm(p.smem_bytes) == per_sm
        assert (p.splits, p.entries_per_split) == (splits, eps)
        assert p.grid == (64, splits) and B * K * p.splits >= pa.SMS
        assert B * K * p.splits <= per_sm * pa.SMS < B * K * (p.splits + 1)
    # a card of other size gets one wave as well
    p = pa.plan(B, K, G, 128, bs, maxb, torch.bfloat16, sms=66)
    assert (p.splits, p.entries_per_split) == (2, 35)


@pytest.mark.parametrize("B,K", [(1, 1), (8, 8), (64, 8), (600, 1)])
def test_paged_one_entry_table_is_one_split(B, K):
    for dtype in (torch.float32, torch.bfloat16):
        p = pa.plan(B, K, 4, 64, 16, 1, dtype)
        assert p.splits == 1 and p.workspace_bytes == 0
    # a full grid writes the output directly too
    assert pa.plan(600, 1, 4, 128, 16, 69, torch.bfloat16).splits == 1


@pytest.mark.parametrize("G", [1, 4, 16, 17, 32, 64])
@pytest.mark.parametrize("r", [8, 16, 24, 64, 128, 200, 256])
def test_paged_shared_memory_fits(G, r):
    for maxb in (1, 69, 4096, 64 * pa.MAX_ENTRIES):
        # bf16: two blocks per SM even with the longest live list
        p = pa.plan(1, 1, G, r, 16, maxb, torch.bfloat16)
        assert 2 * (p.smem_bytes + 1024) <= _SMEM_PER_SM
        # f32 (q rows in shared memory as well): one block at least
        p = pa.plan(1, 1, G, r, 16, maxb, torch.float32)
        assert p.smem_bytes <= _SMEM_LIMIT
    with pytest.raises(ValueError, match="longer"):
        pa.plan(1, 1, G, r, 16, 64 * pa.MAX_ENTRIES + 1, torch.bfloat16)


@pytest.mark.parametrize("B,K,G,r,bs,maxb", [
    _PAGED_SERVING, (8, 8, 4, 64, 16, 69), (3, 2, 2, 16, 4, 5),
    (1, 1, 64, 256, 16, 512), (2, 1, 8, 8, 4, 40), (4, 4, 16, 128, 32, 9)])
def test_paged_workspace_matches_formula(B, K, G, r, bs, maxb):
    for dtype in (torch.float32, torch.bfloat16):
        p = pa.plan(B, K, G, r, bs, maxb, dtype)
        want = 4 * B * K * p.splits * G * (r + 2) if p.splits > 1 else 0
        assert p.workspace_bytes == want
        es = 4 if dtype == torch.float32 else 2
        ring = pa.STAGES * 2 * p.stage_tokens * (p.rank + 16 // es) * es
        q_rows = -(-G // 16) * 16 * (p.rank + 4) * 4 if es == 4 else 0
        assert p.smem_bytes == (ring + q_rows + pa.STAGES * p.stage_tokens
                                * 4 + -(-12 * p.entries_per_split // 16) * 16
                                + 2 * pa.MAX_ROWS * 4 + 16)


@pytest.mark.parametrize("r", [1, 8, 15, 16, 17, 32, 48, 64, 96, 128, 129,
                               256])
def test_paged_plan_routes_by_dtype_and_rank(r):
    want = next(w for w in (16, 32, 64, 128, 256) if w >= r)
    bf = pa.plan(2, 2, 4, r, 16, 8, torch.bfloat16)
    f32 = pa.plan(2, 2, 4, r, 16, 8, torch.float32)
    assert (bf.body, f32.body) == ("mma", "fma")
    assert bf.rank == f32.rank == want
    # a stage holds ~16 KB of K: 64 tokens while that fits
    assert bf.stage_tokens == min(64, 8192 // want)
    assert f32.stage_tokens == min(64, 4096 // want)
    assert bf.threads == f32.threads == 128
    for bad in (0, 257):
        with pytest.raises(ValueError, match="rank"):
            pa.plan(2, 2, 4, bad, 16, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="rows"):
        pa.plan(2, 2, 65, r, 16, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        pa.plan(2, 2, 4, r, 16, 8, torch.float16)


def test_paged_scratch_counters_stay_zero_as_they_grow():
    """The split scratch is [counters | workspace] per (device, stream):
    counters must read zero whenever a call needs more of them than the
    buffer had, even where an earlier call's workspace was."""
    dev = torch.device("cpu")
    key = (dev.index, -1)
    pa._SCRATCH.pop(key, None)
    try:
        cnt, ws = pa._scratch(dev, -1, 64, 4096)
        buf, head = pa._SCRATCH[key]
        assert (cnt, ws - cnt) == (buf.data_ptr(), head) and head >= 4 * 64
        assert ws % 16 == 0 and buf.numel() >= head + 4096
        buf.fill_(0xFF)                 # a kernel's workspace, written
        buf[:head] = 0                  # its counters, reset by the kernel
        cnt, ws = pa._scratch(dev, -1, 64, 1024)       # reused as it is
        assert pa._SCRATCH[key][0] is buf
        cnt, ws = pa._scratch(dev, -1, 1000, 16)       # more counters
        buf, head = pa._SCRATCH[key]
        assert head >= 4 * 1000 and ws - cnt == head
        assert not buf[:head].any()
    finally:
        pa._SCRATCH.pop(key, None)
