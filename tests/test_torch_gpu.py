"""The port's CUDA kernels against their plain versions, on the card.

Each test skips without a CUDA device (decided inside the fixture, never
at import). It needs neither jax nor the suite's conftest, so on a card
without jax run it as
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py``."""
import pytest
import torch

from repro_torch.kernels.cur_matmul import cur_matmul as cm
from repro_torch.kernels.cur_matmul.ref import cur_matmul_ref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import layers

_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def rel_err(y, yr) -> float:
    """Scale-relative max error (tests/test_kernels.py::_assert_close)."""
    y, yr = y.float(), yr.float()
    return float((y - yr).abs().max() / (yr.abs().max() + 1e-9))


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,m,rk,n", [
    (256, 128, 32, 256), (128, 256, 64, 512), (512, 64, 16, 128),
    (96, 100, 24, 200), (64, 512, 512, 64), (1, 128, 16, 128)])
def test_cur_matmul_kernel_matches_plain(gen, M, m, rk, n, dtype):
    x, cu, r = (_randn(gen, s, dtype) for s in ((M, m), (m, rk), (rk, n)))
    before = cm.launches
    y = cm.cur_matmul(x, cu, r)
    torch.cuda.synchronize()
    assert cm.launches == before + 1
    assert rel_err(y.cpu(), cur_matmul_ref(x, cu, r).cpu()) < _TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,d,win,causal", [
    (1, 4, 2, 128, 32, 0, True), (2, 4, 4, 64, 16, 0, True),
    (1, 8, 1, 128, 32, 0, True), (1, 4, 2, 128, 32, 48, True),
    (1, 2, 2, 64, 64, 16, True), (1, 4, 2, 100, 16, 0, True),
    (1, 4, 2, 72, 16, 0, False), (1, 4, 2, 130, 128, 0, True)])
def test_flash_kernel_matches_plain(gen, B, H, K, S, d, win, causal, dtype):
    q = _randn(gen, (B, H, S, d), dtype)
    k = _randn(gen, (B, K, S, d), dtype)
    v = _randn(gen, (B, K, S, d), dtype)
    before = fa.launches
    o = fa.flash_attention(q, k, v, causal=causal, window=win, scale=0.3)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=win, scale=0.3)
    assert rel_err(o.cpu(), ref.cpu()) < _TOL[dtype]


@pytest.mark.parametrize("M,m,rk,n", [
    (2048, 4096, 256, 4096), (2048, 4096, 256, 1024),
    (2048, 4096, 256, 14336),                  # wq, wk, w_gate at r_max 256
    (512, 1024, 16, 1024), (512, 1024, 24, 1024), (1024, 2048, 512, 1024),
    (1024, 1000, 64, 520),                     # split edge off a slice edge
    (300, 512, 40, 264)])                      # ragged M and last n tile
def test_cur_matmul_two_pass_body_matches_plain(gen, M, m, rk, n):
    x, cu, r = (_randn(gen, s, torch.bfloat16) * sc for s, sc in
                (((M, m), 1.0), ((m, rk), m ** -0.5), ((rk, n), rk ** -0.5)))
    assert cm.plan(M, m, rk, n, torch.bfloat16).body == "tc"
    before = cm.launches
    y = cm.cur_matmul(x, cu, r)
    torch.cuda.synchronize()
    assert cm.launches == before + 1
    assert rel_err(y.cpu(), cur_matmul_ref(x, cu, r).cpu()) < 2e-2


@pytest.mark.parametrize("M,m,rk,n", [(2048, 4096, 256, 14336),
                                      (96, 100, 24, 200)])
def test_cur_matmul_repeat_is_bit_identical(gen, M, m, rk, n):
    x, cu, r = (_randn(gen, s, torch.bfloat16) for s in
                ((M, m), (m, rk), (rk, n)))
    y0 = cm.cur_matmul(x, cu, r)
    y1 = cm.cur_matmul(x, cu, r)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1)


@pytest.mark.parametrize("B,H,K,S,d,win", [
    (4, 32, 8, 512, 128, 0), (2, 32, 8, 512, 128, 128),
    (1, 8, 2, 1024, 64, 0), (1, 8, 2, 1024, 64, 100)])
def test_flash_kernel_main_shapes_match_plain(gen, B, H, K, S, d, win):
    q = _randn(gen, (B, H, S, d), torch.bfloat16)
    k = _randn(gen, (B, K, S, d), torch.bfloat16)
    v = _randn(gen, (B, K, S, d), torch.bfloat16)
    scale = d ** -0.5
    o = fa.flash_attention(q, k, v, window=win, scale=scale)
    o2 = fa.flash_attention(q, k, v, window=win, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)
    ref = flash_attention_ref(q, k, v, window=win, scale=scale)
    assert rel_err(o.cpu(), ref.cpu()) < 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,win", [
    (1, 4, 1, 100, 0), (1, 4, 4, 130, 8), (2, 4, 1, 200, 0),
    (4, 4, 1, 1024, 512)])                     # gemma3-1b's attention
def test_flash_kernel_head_dim_256_matches_plain(gen, B, H, K, S, win,
                                                 dtype):
    q, k, v = (_randn(gen, s, dtype) for s in
               ((B, H, S, 256), (B, K, S, 256), (B, K, S, 256)))
    before = fa.launches
    o = fa.flash_attention(q, k, v, window=win, scale=256 ** -0.5)
    o2 = fa.flash_attention(q, k, v, window=win, scale=256 ** -0.5)
    torch.cuda.synchronize()
    assert fa.launches == before + 2 and torch.equal(o, o2)
    ref = flash_attention_ref(q, k, v, window=win, scale=256 ** -0.5)
    assert rel_err(o.cpu(), ref.cpu()) < _TOL[dtype]


def test_unaligned_bf16_inputs_take_the_untiled_bodies(gen):
    """A base pointer off 16 bytes cannot be described by TMA: the wrappers
    route it to cur_matmul's one-pass body and flash's mma body."""
    def off(shape):      # a contiguous view 2 bytes into a buffer
        n = 1
        for s in shape:
            n *= s
        buf = _randn(gen, (n + 8,), torch.bfloat16)
        return buf[1:n + 1].view(shape)
    x, cu, r = off((256, 512)), off((512, 64)), off((64, 256))
    assert x.data_ptr() % 16 != 0
    y = cm.cur_matmul(x, cu, r)
    assert rel_err(y.cpu(), cur_matmul_ref(x, cu, r).cpu()) < 2e-2
    q, k, v = off((1, 4, 128, 64)), off((1, 2, 128, 64)), off((1, 2, 128, 64))
    assert fa.plan(1, 4, 128, 64, torch.bfloat16, aligned=False).body == "mma"
    o = fa.flash_attention(q, k, v, scale=0.125)
    ref = flash_attention_ref(q, k, v, scale=0.125)
    assert rel_err(o.cpu(), ref.cpu()) < 2e-2


def test_apply_w_routes_folded_weights_through_kernel(gen):
    x = _randn(gen, (4, 16, 256), torch.float32)
    w = {"CU": _randn(gen, (256, 32), torch.float32),
         "R": _randn(gen, (32, 384), torch.float32)}
    before = cm.launches
    y = layers.apply_w(x, w)
    assert cm.launches == before + 1
    assert rel_err(y.cpu(), ((x @ w["CU"]) @ w["R"]).cpu()) < 2e-5


# ---------------------------------------------------------------------------
# paged_attention (tests/test_paged_attention.py's grid) and serving
# ---------------------------------------------------------------------------

_PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _paged_case(B, K, G, r, nb, bs, maxb, dtype, *, seed=0,
                inactive_last=True):
    """tests/test_paged_attention.py::_case with numpy draws, on the card."""
    import numpy as np
    rng = np.random.RandomState(seed)      # the layout: as in that file
    draw = np.random.RandomState(seed + 1000)
    q, kp, vp = (torch.from_numpy(draw.standard_normal(s).astype(np.float32))
                 .to("cuda", dtype) for s in
                 ((B, K, G, r), (nb, bs, K, r), (nb, bs, K, r)))
    ctx = np.array([rng.randint(0, maxb * bs) for _ in range(B)], np.int32)
    table = np.full((B, maxb), -1, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B):
        if inactive_last and b == B - 1:
            ctx[b] = 0
            continue
        for j in range(ctx[b] // bs + 1):
            table[b, j] = free.pop()
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.from_numpy(ctx).cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,r,nb,bs,maxb,win", [
    (3, 2, 2, 16, 12, 4, 5, 0), (4, 4, 1, 8, 16, 8, 3, 0),
    (2, 1, 4, 32, 8, 16, 2, 0), (3, 2, 3, 16, 12, 4, 5, 7),
    (3, 2, 2, 16, 12, 4, 5, 3), (8, 8, 4, 128, 552, 16, 69, 0)])
def test_paged_kernel_matches_plain(gen, B, K, G, r, nb, bs, maxb, win,
                                    dtype):
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    args = _paged_case(B, K, G, r, nb, bs, maxb, dtype)
    before = pa.launches
    y = pa.paged_attention(*args, window=win)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    yr = paged_attention_ref(*args, window=win)
    assert rel_err(y.cpu(), yr.cpu()) < _PAGED_TOL[dtype]
    assert not y[-1].any() and not yr[-1].any()      # inactive slot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,r,nb,bs,maxb,win,span", [
    (3, 2, 2, 16, 16, 4, 7, 0, 4), (2, 1, 4, 8, 12, 8, 4, 0, 2),
    (3, 2, 3, 16, 16, 4, 7, 5, 3)])
def test_paged_kernel_q_span_matches_plain(gen, B, K, G, r, nb, bs, maxb,
                                           win, span, dtype):
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    q, kp, vp, table, ctx = _paged_case(B, K, span * G, r, nb, bs, maxb,
                                        dtype, inactive_last=False)
    ctx = torch.clamp(torch.minimum(
        ctx, (table >= 0).sum(1).int() * bs - span), min=0)
    y = pa.paged_attention(q, kp, vp, table, ctx, window=win, q_span=span)
    yr = paged_attention_ref(q, kp, vp, table, ctx, window=win, q_span=span)
    assert rel_err(y.cpu(), yr.cpu()) < _PAGED_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,r,bs,maxb,win", [
    (3, 2, 4, 16, 4, 80, 0),       # splits > 1, dead splits, inactive slot
    (3, 2, 4, 8, 8, 40, 0),        # r 8, zero-padded to 16
    (3, 2, 4, 12, 8, 40, 0),       # r 12: plain loads (rows not 16 bytes)
    (4, 2, 4, 64, 16, 69, 0),
    (4, 2, 4, 128, 16, 69, 100),   # a window that starts inside a split
    (2, 2, 8, 256, 32, 40, 0),     # r 256, bs 32
    (2, 1, 20, 128, 16, 69, 37),   # rows past one m16 tile, window
])
def test_paged_kernel_splits_match_plain(gen, B, K, G, r, bs, maxb, win,
                                         dtype):
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    p = pa.plan(B, K, G, r, bs, maxb, dtype,
                sms=pa._sm_count(torch.cuda.current_device()))
    assert p.splits > 1
    args = _paged_case(B, K, G, r, B * maxb, bs, maxb, dtype)
    before = pa.launches
    y = pa.paged_attention(*args, window=win)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    yr = paged_attention_ref(*args, window=win)
    assert rel_err(y.cpu(), yr.cpu()) < _PAGED_TOL[dtype]
    assert not y[-1].any()                           # inactive slot
    # the counters are back at 0: a second call gives the same bits
    assert torch.equal(y, pa.paged_attention(*args, window=win))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("span,win", [(2, 0), (3, 21), (4, 0)])
def test_paged_kernel_q_span_with_splits(gen, span, win, dtype):
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B, K, G, r, bs, maxb = 3, 2, 4 * span, 64, 8, 40
    q, kp, vp, table, ctx = _paged_case(B, K, G, r, B * maxb, bs, maxb,
                                        dtype, inactive_last=False)
    ctx = torch.clamp(torch.minimum(
        ctx, (table >= 0).sum(1).int() * bs - span), min=0)
    assert pa.plan(B, K, G, r, bs, maxb, dtype).splits > 1
    y = pa.paged_attention(q, kp, vp, table, ctx, window=win, q_span=span)
    yr = paged_attention_ref(q, kp, vp, table, ctx, window=win, q_span=span)
    assert rel_err(y.cpu(), yr.cpu()) < _PAGED_TOL[dtype]


def test_paged_kernel_strided_pools_match_plain(gen):
    """Pools that are views of a wider buffer (row and head strides of
    the buffer), as one layer's slice of a stacked pool."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B, K, G, r, bs, maxb = 4, 2, 4, 64, 16, 40
    q, kp, vp, table, ctx = _paged_case(B, K, G, r, B * maxb, bs, maxb,
                                        torch.bfloat16)
    wide_k = torch.zeros(B * maxb, bs, K, r + 64, dtype=torch.bfloat16,
                         device="cuda")
    wide_v = torch.zeros_like(wide_k)
    wide_k[..., 8:8 + r] = kp
    wide_v[..., 8:8 + r] = vp
    kv, vv = wide_k[..., 8:8 + r], wide_v[..., 8:8 + r]
    assert not kv.is_contiguous()
    y = pa.paged_attention(q, kv, vv, table, ctx)
    yr = paged_attention_ref(q, kp, vp, table, ctx)
    assert rel_err(y.cpu(), yr.cpu()) < _PAGED_TOL[torch.bfloat16]


def test_paged_kernel_repeat_is_bit_identical(gen):
    """At the serving shape (8 splits per (slot, kv-head)): the splits are
    merged in a fixed order, so two calls give the same bits."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    args = _paged_case(8, 8, 4, 128, 552, 16, 69, torch.bfloat16)
    y = pa.paged_attention(*args)
    for _ in range(3):
        assert torch.equal(y, pa.paged_attention(*args))


def test_paged_kernel_raises_on_bad_shapes(gen):
    from repro_torch.kernels.paged_attention import paged_attention as pa
    z = torch.zeros
    table = z((2, 2), dtype=torch.int32, device="cuda")
    ctx = z((2,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="mismatch"):
        pa.paged_attention(z((2, 2, 2, 8), device="cuda"),
                           z((4, 4, 2, 8), device="cuda"),
                           z((4, 4, 2, 4), device="cuda"), table, ctx)
    with pytest.raises(ValueError, match="q_span"):
        pa.paged_attention(z((2, 2, 6, 8), device="cuda"),
                           z((4, 4, 2, 8), device="cuda"),
                           z((4, 4, 2, 8), device="cuda"), table, ctx,
                           q_span=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 48])
def test_flash_adaptor_pads_feature_dim(gen, d, dtype):
    """Rank-space prefill at a CUR-KV rank between the kernel's widths:
    the registry zero-pads d, runs the kernel and slices back."""
    from repro_torch.attention import registry
    B, S, K, G = 2, 96, 2, 2
    qg = (torch.randn((B, S, K, G, d), generator=gen, device="cuda")
          * d ** -0.5).to(dtype)
    k = _randn(gen, (B, S, K, d), dtype)
    v = _randn(gen, (B, S, K, d), dtype)
    pos = torch.arange(S, device="cuda")[None].expand(B, S)
    before = fa.launches
    o = registry._mix_flash_cuda(qg, k, v, pos, pos, 0, 1.0, chunk=0)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = flash_attention_ref(
        qg.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, d),
        k.transpose(1, 2), v.transpose(1, 2), scale=1.0)
    ref = ref.reshape(B, K, G, S, d).permute(0, 3, 1, 2, 4)
    assert rel_err(o.cpu(), ref.cpu()) < _TOL[dtype]


@pytest.mark.parametrize("cur_kv", [False, True])
def test_server_on_card_matches_cpu(gen, cur_kv):
    """A small f32 Server on the card gives the CPU's greedy tokens, with
    every decode attention through the kernel."""
    import numpy as np
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.launch.serve import make_workload
    from repro_torch.models import init_params
    from repro_torch.serving import PagedConfig, Server
    cfg = get_smoke("llama3.1-8b")
    params = init_params(0, cfg, "cpu")
    wl = make_workload(6, cfg.vocab_size, max_new=10)
    calib = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 64))
    pc = PagedConfig.sized_for(60, 4, block_size=8, cur_kv=cur_kv,
                               kv_rank=cfg.resolved_head_dim // 2)
    outs = {}
    for dev, prm in (("cpu", params),
                     ("cuda", tree_map(lambda t: t.cuda(), params))):
        srv = Server(prm, cfg, pc, max_concurrency=4, calib_tokens=calib,
                     device=dev)
        before = pa.launches
        for w in wl:
            srv.submit(w["prompt"], w["max_new_tokens"])
        srv.drain()
        outs[dev] = {k: r.out_tokens for k, r in srv.finished.items()}
        if dev == "cuda":
            assert (pa.launches - before
                    == srv.stats()["n_decode_steps"] * cfg.n_layers)
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# the speculative slice: verify shapes, M 40, spec-on == spec-off
# ---------------------------------------------------------------------------

# llama3.1-8b's verify at spec_k 4 on 8 slots: G' = (k + 1) G = 20
_VERIFY_CTX = (256, 375, 494, 613, 732, 851, 970, 1088)


def _verify_case(gen, span, r, dtype, B=8, K=8, G=4, bs=16, maxb=69):
    """Verify-layout inputs: q (B, K, span G, r), a pool of B maxb blocks,
    each slot's table a random permutation with the entries past
    ctx + span - 1 unassigned (ragged contexts, split tables)."""
    q = _randn(gen, (B, K, span * G, r), dtype)
    kp = _randn(gen, (B * maxb, bs, K, r), dtype)
    vp = _randn(gen, (B * maxb, bs, K, r), dtype)
    table = torch.randperm(B * maxb, device="cuda", generator=gen).reshape(
        B, maxb).int()
    ctx = torch.tensor(_VERIFY_CTX[:B], dtype=torch.int32, device="cuda")
    j = torch.arange(maxb, device="cuda")[None]
    table = torch.where(j <= (ctx[:, None] + span - 1) // bs, table, -1)
    return q, kp, vp, table.int(), ctx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [128, 64])
@pytest.mark.parametrize("span", [2, 5, 8])
def test_paged_kernel_verify_shapes_match_plain(gen, span, r, dtype):
    """q_span 2 / 5 / 8 at the full-width verify shape (G' 8 / 20 / 32,
    more than one m16 tile past span 4) on split tables: within the plain
    version's bound, and two calls give the same bits."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    args = _verify_case(gen, span, r, dtype)
    assert pa.plan(8, 8, span * 4, r, 16, 69, dtype).splits > 1
    before = pa.launches
    y = pa.paged_attention(*args, q_span=span)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    yr = paged_attention_ref(*args, q_span=span)
    assert rel_err(y.cpu(), yr.cpu()) < _PAGED_TOL[dtype]
    assert torch.equal(y, pa.paged_attention(*args, q_span=span))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,rk,n", [(4096, 256, 4096), (4096, 256, 1024),
                                    (4096, 256, 14336)])
def test_cur_matmul_verify_rows_match_plain(gen, m, rk, n, dtype):
    """M 40 = 8 slots x 5 verify positions: above the M >= 32 gate, so the
    verify forward's folded weights take the kernel."""
    M = 40
    x = _randn(gen, (M, m), dtype)
    cu = (_randn(gen, (m, rk), torch.float32) * m ** -0.5).to(dtype)
    rr = (_randn(gen, (rk, n), torch.float32) * rk ** -0.5).to(dtype)
    assert layers.use_cur_kernel(m, rk, n, M, on_cuda=True)
    y = cm.cur_matmul(x, cu, rr)
    torch.cuda.synchronize()
    assert rel_err(y.cpu(), cur_matmul_ref(x, cu, rr).cpu()) < _TOL[dtype]
    assert torch.equal(y, cm.cur_matmul(x, cu, rr))


@pytest.mark.parametrize("cur_kv", [False, True])
def test_server_spec_on_card_matches_spec_off(gen, cur_kv):
    """A small f32 Server on the card: greedy tokens with a self-draft
    (k 3) equal the card's spec-off tokens and the CPU's spec-on tokens;
    verify runs the kernel at q_span 4, every block returns."""
    import numpy as np
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.launch.serve import make_workload
    from repro_torch.models import init_params
    from repro_torch.serving import PagedConfig, Server
    cfg = get_smoke("llama3.1-8b")
    params = init_params(0, cfg, "cpu")
    wl = make_workload(6, cfg.vocab_size, max_new=10)
    calib = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 64))
    pc = PagedConfig.sized_for(60, 4, block_size=8, cur_kv=cur_kv,
                               kv_rank=cfg.resolved_head_dim // 2)
    outs = {}
    for dev, k in (("cuda", 0), ("cuda", 3), ("cpu", 3)):
        prm = params if dev == "cpu" else tree_map(lambda t: t.cuda(),
                                                   params)
        srv = Server(prm, cfg, pc, max_concurrency=4, calib_tokens=calib,
                     draft_params=prm if k else None, spec_k=k, device=dev)
        before = pa.launches
        for w in wl:
            srv.submit(w["prompt"], w["max_new_tokens"])
        srv.drain()
        outs[dev, k] = {i: r.out_tokens for i, r in srv.finished.items()}
        assert srv.scheduler.alloc.n_free == pc.n_blocks
        if dev == "cuda" and k:
            st = srv.stats()
            assert st["n_spec_windows"] > 0 and st["spec_accept_rate"] == 1.0
            assert pa.launches - before >= st["n_spec_windows"] * 2 * \
                cfg.n_layers
    assert outs["cuda", 3] == outs["cuda", 0] == outs["cpu", 3]


# ---------------------------------------------------------------------------
# the static-batch engine and the checkpoint manager on the card
# ---------------------------------------------------------------------------

def test_engine_on_card_matches_cpu(gen):
    """``generate`` on a CURed f32 REPRO model: the card's greedy tokens
    equal the CPU's and its logprobs agree within 2e-5; the prefill (M =
    4 x 16 rows) runs flash_attention and cur_matmul."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_repro
    from repro_torch.configs.base import CURConfig
    from repro_torch.core import calibrate, compress_model
    from repro_torch.models import init_params
    from repro_torch.serve import generate
    cfg = get_repro()
    params = init_params(0, cfg, "cpu")
    g = torch.Generator().manual_seed(2)
    calib = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                      generator=g)}]
    cp, ccfg, _ = compress_model(params, cfg, CURConfig(
        r_max=32, n_compress_layers=2, svd="exact", fold_u=True), calibrate(
            params, cfg, calib))
    prompts = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    ref = generate(cp, ccfg, prompts, 8)
    c0, f0 = cm.launches, fa.launches
    out = generate(tree_map(lambda t: t.cuda(), cp), ccfg, prompts.cuda(), 8)
    assert cm.launches > c0 and fa.launches > f0
    assert torch.equal(out.tokens.cpu(), ref.tokens)
    assert rel_err(out.logprobs.cpu(), ref.logprobs) < _TOL[torch.float32]


def test_server_paged_kernel_off_on_card_matches_kernel(gen):
    """``paged_kernel="off"`` is the caller's explicit choice of the plain
    paged attention on the card: no kernel launch, the kernel's tokens."""
    import numpy as np
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.launch.serve import make_workload
    from repro_torch.models import init_params
    from repro_torch.serving import PagedConfig, Server
    cfg = get_smoke("llama3.1-8b")
    params = tree_map(lambda t: t.cuda(), init_params(0, cfg, "cpu"))
    wl = make_workload(6, cfg.vocab_size, max_new=10)
    calib = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 64))
    pc = PagedConfig.sized_for(60, 4, block_size=8)
    outs, launched = {}, {}
    for mode in ("auto", "off"):
        srv = Server(params, cfg, pc, max_concurrency=4, calib_tokens=calib,
                     device="cuda", paged_kernel=mode)
        before = pa.launches
        for w in wl:
            srv.submit(w["prompt"], w["max_new_tokens"])
        srv.drain()
        outs[mode] = {k: r.out_tokens for k, r in srv.finished.items()}
        launched[mode] = pa.launches - before
        assert srv.stats()["attn_backends"]["paged_decode"] == (
            "paged_cuda" if mode == "auto" else "paged_ref")
    assert outs["off"] == outs["auto"]
    assert launched["auto"] > 0 and launched["off"] == 0


def test_checkpoint_roundtrip_on_card(gen, tmp_path):
    """A bf16 / f32 / int32 tree saved from the card restores on the card
    (the default device) and on the CPU bit-identical."""
    from repro_torch.dist import (
        CheckpointManager, load_tree_template, save_tree_template)
    tree = {"w": _randn(gen, (64, 48), torch.bfloat16),
            "groups": [{"CU": _randn(gen, (48, 8), torch.float32)}],
            "step": torch.tensor(3, dtype=torch.int32, device="cuda")}
    mgr = CheckpointManager(str(tmp_path), keep_n=1)
    mgr.save(3, tree, blocking=False)
    mgr.wait()
    save_tree_template(str(tmp_path / "template.json"), tree)
    tmpl = load_tree_template(str(tmp_path / "template.json"))
    for dev in ("cuda", "cpu"):
        step, back = mgr.restore(tmpl, device=None if dev == "cuda"
                                 else "cpu")
        assert step == 3 and back["w"].device.type == dev
        assert torch.equal(back["w"].cpu(), tree["w"].cpu())
        assert torch.equal(back["groups"][0]["CU"].cpu(),
                           tree["groups"][0]["CU"].cpu())
        assert back["step"].dtype == torch.int32 and int(back["step"]) == 3


# ---------------------------------------------------------------------------
# training and healing on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,S,d,win", [
    (1, 2, 1, 40, 16, 0), (2, 1, 2, 33, 32, 0), (1, 2, 4, 72, 64, 8),
    (1, 1, 2, 130, 128, 0), (2, 2, 2, 64, 32, 8)])
def test_flash_attention_fn_gradients_match_ref(gen, B, K, G, S, d, win,
                                                dtype):
    """FlashAttentionFn on the card: the kernel's forward, the plain
    backward; dq / dk / dv against autograd through the plain forward."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    q = _randn(gen, (B, K * G, S, d), dtype)
    k = _randn(gen, (B, K, S, d), dtype)
    v = _randn(gen, (B, K, S, d), dtype)
    do = _randn(gen, (B, K * G, S, d), dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fa.launches
    o = flash_attention_op(*leaves, window=win, scale=0.3)
    assert fa.launches == before + 1 and o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention_ref(
        *ref_leaves, window=win, scale=0.3), ref_leaves, do)
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        assert rel_err(g.cpu(), r.cpu()) < _TOL[dtype]


def test_forward_only_ops_raise_under_grad_on_card(gen):
    from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
    from repro_torch.kernels.paged_attention.ops import paged_attention_op
    x, cu, r = (_randn(gen, s, torch.bfloat16)
                for s in ((64, 128), (128, 16), (16, 128)))
    cu.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        cur_matmul_op(x, cu, r)
    q, kp, vp, table, ctx = _paged_case(2, 2, 2, 16, 8, 4, 4,
                                        torch.float32)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_attention_op(q, kp, vp, table, ctx)
    with torch.no_grad():
        assert cur_matmul_op(x, cu, r).shape == (64, 128)


def test_smoke_heal_step_card_equals_cpu(gen):
    """One dU-only heal step of a healing-form SMOKE model (f32): the KD
    loss and every dU gradient on the card (flash kernel under autograd)
    against the CPU, 2e-5."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import CURConfig
    from repro_torch.core import calibrate, compress_model
    from repro_torch.core import heal
    from repro_torch.dist import tree_flatten
    from repro_torch.models import forward_hidden, init_params
    cfg = get_smoke("llama3.1-8b")
    params = init_params(0, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 65),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    sp, scfg, _ = compress_model(params, cfg, CURConfig(
        r_max=8, n_compress_layers=2), calibrate(params, cfg, [batch]))
    out = {}
    for dev in ("cpu", "cuda"):
        p, s = (tree_map(lambda t: t.to(dev), x) for x in (params, sp))
        b = tree_map(lambda t: t.to(dev), batch)
        tr, fr = heal.partition_params(s, heal.trainable_mask(s, "dU"))
        with torch.no_grad():
            t_log, t_hid = forward_hidden(p, cfg, b)
        before = fa.launches
        out[dev] = heal.value_and_grad(lambda t: heal.kd_loss_fn(
            heal.combine_params(t, fr), scfg, b, t_log, t_hid), tr)
        if dev == "cuda":
            assert fa.launches - before == cfg.n_layers
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert rel_err(lg.cpu(), lc) < 2e-5
    for a, b_ in zip(tree_flatten(gg), tree_flatten(gc)):
        assert rel_err(a.cpu(), b_) < 2e-5
