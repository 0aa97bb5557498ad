"""Gradients through the port's attention kernels.

``flash_attention_bwd`` (the plain backward of ``FlashAttentionFn``)
against ``jax.vjp`` of the JAX package's dense attention
(``repro.attention.xla.dense_attn``) and against autograd of the port's
plain forward; ``FlashAttentionFn`` and the registry adaptor's pad and
permutes under autograd (the kernel's forward replaced by its plain
version, so that it runs without a card); the forward-only ops raising
under grad; and the model functions being differentiable. f32 2e-5,
bf16 2e-2, scale-relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import xla as jax_xla
from repro_torch.attention import registry
from repro_torch.attention import xla as t_xla
from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.ops import paged_attention_op

from _torch_helpers import assert_close

torch.set_num_threads(1)

# B, K, G, S, d, window: the kernel's grid (d 16/32/64/128, G 1/2/4,
# windows, ragged S)
GRID = [(1, 2, 1, 40, 16, 0), (2, 1, 2, 33, 32, 0), (1, 2, 4, 72, 64, 8),
        (1, 1, 2, 50, 128, 0), (2, 2, 2, 64, 32, 8), (1, 4, 1, 17, 16, 8)]


def _inputs(B, K, G, S, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K * G, S, d)).astype(np.float32)
    k = rng.standard_normal((B, K, S, d)).astype(np.float32)
    v = rng.standard_normal((B, K, S, d)).astype(np.float32)
    do = rng.standard_normal((B, K * G, S, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("B,K,G,S,d,window", GRID)
def test_flash_bwd_matches_jax_dense_vjp(B, K, G, S, d, window):
    q, k, v, do = _inputs(B, K, G, S, d)
    scale = d ** -0.5
    # the JAX mix layout: q (B,S,K,G,d), k/v (B,S,K,d)
    jq = jnp.asarray(q.reshape(B, K, G, S, d).transpose(0, 3, 1, 2, 4))
    jk = jnp.asarray(k.transpose(0, 2, 1, 3))
    jv = jnp.asarray(v.transpose(0, 2, 1, 3))
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))

    @jax.jit
    def fwd_bwd(a, b, c, g):
        o, vjp = jax.vjp(lambda x, y, z: jax_xla.dense_attn(
            x, y, z, pos, pos, window, scale), a, b, c)
        return (o,) + vjp(g)
    jdo = jnp.asarray(do.reshape(B, K, G, S, d).transpose(0, 3, 1, 2, 4))
    jo, jdq, jdk, jdv = fwd_bwd(jq, jk, jv, jdo)
    o = np.array(jo).transpose(0, 2, 3, 1, 4).reshape(B, K * G, S, d)
    dq, dk, dv = flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, o, do)), causal=True,
        window=window, scale=scale)
    assert_close(dq.numpy(), np.asarray(jdq).transpose(0, 2, 3, 1, 4)
                 .reshape(B, K * G, S, d))
    assert_close(dk.numpy(), np.asarray(jdk).transpose(0, 2, 1, 3))
    assert_close(dv.numpy(), np.asarray(jdv).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,K,G,S,d,window", GRID[:4])
def test_flash_bwd_matches_ref_autograd(B, K, G, S, d, window, causal,
                                        dtype, tol):
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(B, K, G, S, d, seed=1))
    scale = 0.3
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention_ref(*leaves, causal=causal, window=window,
                            scale=scale)
    ref = torch.autograd.grad(o, leaves, do)
    got = flash_attention_bwd(q, k, v, o.detach(), do, causal=causal,
                              window=window, scale=scale)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert_close(g.float().numpy(), r.float().numpy(), tol)


@pytest.fixture
def kernel_is_plain(monkeypatch):
    """The kernel's forward replaced by its plain version (so it runs
    without a card), counting calls as the wrapper does."""
    calls = []

    def fake(q, k, v, *, causal=True, window=0, scale=None):
        calls.append(q.shape)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    monkeypatch.setattr(fa_ops._kernel, "flash_attention", fake)
    return calls


def test_flash_attention_fn_gradients(kernel_is_plain):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 48, 32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa_ops.FlashAttentionFn.apply(*leaves, True, 8, 0.25)
    assert o.grad_fn is not None and len(kernel_is_plain) == 1
    got = torch.autograd.grad(o, leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention_ref(
        *ref_leaves, causal=True, window=8, scale=0.25), ref_leaves, do)
    for g, r in zip(got, ref):
        assert_close(g.numpy(), r.numpy())
    with torch.no_grad():
        assert fa_ops.FlashAttentionFn.apply(q, k, v, True, 0, 0.25) \
            .grad_fn is None


@pytest.mark.parametrize("d", [24, 32])
def test_registry_adaptor_gradients_pad_and_slice(kernel_is_plain,
                                                  monkeypatch, d):
    """The flash_cuda adaptor under autograd: the zero-padded feature
    columns get zero gradient and are sliced off, and the gradients equal
    those through the dense plain attention."""
    B, S, K, G = 2, 40, 2, 2
    rng = np.random.default_rng(2)
    qg, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((B, S, K, G, d), (B, S, K, d), (B, S, K, d)))
    do = torch.from_numpy(rng.standard_normal((B, S, K, G, d)).astype(
        np.float32))
    pos = torch.arange(S)[None].expand(B, S)
    leaves = [t.clone().requires_grad_(True) for t in (qg, k, v)]
    # the adaptor calls the op, which takes the plain route for CPU
    # tensors; route it through FlashAttentionFn as on the card
    def via_fn(q, kk, vv, *, causal=True, window=0, scale=None):
        return fa_ops.FlashAttentionFn.apply(
            q.contiguous(), kk.contiguous(), vv.contiguous(), causal,
            window, scale)
    monkeypatch.setattr(fa_ops, "flash_attention_op", via_fn)
    o = registry._mix_flash_cuda(*leaves, pos, pos, 4, 0.3, chunk=0)
    assert kernel_is_plain == [(B, K * G, S, registry._padded_dim(d))]
    got = torch.autograd.grad(o, leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (qg, k, v)]
    ref = torch.autograd.grad(t_xla.dense_attn(*ref_leaves, pos, pos, 4,
                                               0.3), ref_leaves, do)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert_close(g.numpy(), r.numpy())


def test_flash_op_on_cpu_is_differentiable():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 16, 16))
    q.requires_grad_(True)
    o = fa_ops.flash_attention_op(q, k, v)
    (dq,) = torch.autograd.grad(o, [q], do)
    assert torch.isfinite(dq).all() and fa.launches == 0


def test_cur_matmul_op_raises_under_grad():
    x, cu, r = torch.randn(4, 8), torch.randn(8, 2), torch.randn(2, 6)
    y = cur_matmul_op(x, cu, r)                    # nothing requires grad
    assert y.shape == (4, 6)
    cu.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        cur_matmul_op(x, cu, r)
    with torch.no_grad():
        assert cur_matmul_op(x, cu, r).grad_fn is None


def test_paged_attention_op_raises_under_grad():
    B, K, G, r, nb, bs, maxb = 2, 2, 2, 8, 4, 4, 2
    q = torch.randn(B, K, G, r)
    kp, vp = torch.randn(nb, bs, K, r), torch.randn(nb, bs, K, r)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    ctx = torch.tensor([5, 7], dtype=torch.int32)
    assert paged_attention_op(q, kp, vp, table, ctx).shape == q.shape
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_attention_op(q, kp, vp, table, ctx)
    with torch.no_grad():
        paged_attention_op(q, kp, vp, table, ctx)


def test_model_functions_are_differentiable():
    """forward / forward_hidden / loss_fn carry no no_grad: every param
    of a SMOKE model gets a finite, nonzero gradient."""
    from repro_torch.bridge import flatten_up_to, tree_map
    from repro_torch.configs import get_smoke
    from repro_torch.core.heal import value_and_grad
    from repro_torch.models import forward_hidden, init_params, loss_fn
    cfg = get_smoke("llama3.1-8b")
    params = init_params(0, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    loss, grads = value_and_grad(lambda p: loss_fn(p, cfg, batch), params)
    for g in flatten_up_to(grads, grads):
        assert torch.isfinite(g).all() and g.abs().sum() > 0
    logits, hidden = forward_hidden(tree_map(
        lambda t: t.detach().requires_grad_(True), params), cfg, batch)
    assert logits.requires_grad and hidden.requires_grad
