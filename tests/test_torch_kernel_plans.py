"""The launch plans of the port's two redesigned kernels, on the CPU.

``cur_matmul.plan`` and ``flash_attention.plan`` are plain functions of
the shape that the wrappers launch with; ``work_items`` and ``kv_tiles``
mirror the sources' tile walks. Held here over the JAX suite's case grids
(tests/test_kernels.py), the card-only grids (tests/test_torch_gpu.py) and
the main path's shapes (chip_smoke.py): every output tile is covered
exactly once, pass 1's splits partition m, shapes TMA cannot describe take
the one-pass body, and the workspace matches its formula."""
import itertools

import pytest
import torch

from repro_torch.kernels.cur_matmul import cur_matmul as cm
from repro_torch.kernels.flash_attention import flash_attention as fa

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
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,d,win,causal", _FLASH_CASES)
def test_flash_plan_covers_every_query_row(B, H, K, S, d, win, causal,
                                           dtype):
    p = fa.plan(B, H, S, d, dtype)
    if dtype == torch.bfloat16:   # wgmma and TMA for d 64 and 128
        assert p.body == ("wg" if d >= 64 else "mma")
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


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_plan_shared_memory_fits_two_blocks_per_sm(d):
    # the bf16 bodies' K/V rings and q tile leave room for two blocks per SM
    for aligned in (True, False):
        p = fa.plan(1, 1, 64, d, torch.bfloat16, aligned=aligned)
        assert 2 * p.smem_bytes <= _SMEM_LIMIT
