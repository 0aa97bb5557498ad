"""The port's paged-attention plain version against the JAX package's
reference and its Pallas kernel (interpret mode), over the grid of
tests/test_paged_attention.py: ragged ctx_len, GQA/MHA/MQA, sliding
window, bf16, the q_span verify layout, inactive slots and the raises.
Inputs are numpy draws from a seed handed to both packages; tolerances
are that file's own (1e-5 f32, 2e-2 bf16, scale-relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_attention_op as jax_op
from repro.kernels.paged_attention.ref import fold_q as jax_fold_q
from repro.kernels.paged_attention.ref import (
    paged_attention_ref as jax_ref)
from repro.kernels.paged_attention.ref import unfold_o as jax_unfold_o
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    fold_q, paged_attention_ref, unfold_o)

from _torch_helpers import assert_close

torch.set_num_threads(1)

_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(B, K, G, r, nb, bs, maxb, *, seed=0, inactive_last=True):
    """tests/test_paged_attention.py::_case with numpy draws: random
    pools, a ragged table (just enough blocks per row, the rest -1) and
    optionally one inactive slot (ctx 0, no blocks)."""
    rng = np.random.RandomState(seed)      # the layout: as in that file
    draw = np.random.RandomState(seed + 1000)
    q = draw.standard_normal((B, K, G, r)).astype(np.float32)
    kp = draw.standard_normal((nb, bs, K, r)).astype(np.float32)
    vp = draw.standard_normal((nb, bs, K, r)).astype(np.float32)
    ctx = np.array([rng.randint(0, maxb * bs) for _ in range(B)], np.int32)
    table = np.full((B, maxb), -1, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B):
        if inactive_last and b == B - 1:
            ctx[b] = 0
            continue
        for j in range(ctx[b] // bs + 1):
            table[b, j] = free.pop()
    return q, kp, vp, table, ctx


def _both(arrays, dtype="float32"):
    """The same numpy arrays as JAX and torch inputs (floats cast to
    ``dtype``, integers as they are)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j, t = [], []
    for a in arrays:
        if a.dtype == np.float32:
            j.append(jnp.asarray(a).astype(jdt))
            t.append(torch.from_numpy(a).to(tdt))
        else:
            j.append(jnp.asarray(a))
            t.append(torch.from_numpy(a))
    return j, t


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y, np.float32)


@pytest.mark.parametrize("B,K,G,r,nb,bs,maxb,win", [
    (3, 2, 2, 16, 12, 4, 5, 0),     # GQA, ragged ctx
    (4, 4, 1, 8, 16, 8, 3, 0),      # MHA
    (2, 1, 4, 32, 8, 16, 2, 0),     # MQA
    (3, 2, 3, 16, 12, 4, 5, 7),     # sliding window
    (3, 2, 2, 16, 12, 4, 5, 3),     # window < block_size
])
def test_ref_matches_jax_ref_and_kernel(B, K, G, r, nb, bs, maxb, win):
    j, t = _both(_case(B, K, G, r, nb, bs, maxb))
    y = paged_attention_ref(*t, window=win)
    yj = jax_ref(*j, window=win)
    yk = jax_op(*j, window=win)
    assert_close(_np(y), _np(yj), _TOL["float32"])
    assert_close(_np(y), _np(yk), _TOL["float32"])
    # the CPU op is the plain version, bit for bit
    np.testing.assert_array_equal(
        _np(ops.paged_attention_op(*t, window=win)), _np(y))
    # inactive slot (all -1 table row): exact zeros
    assert not y[-1].any()


def test_ref_bf16_matches_jax():
    j, t = _both(_case(2, 2, 2, 16, 8, 4, 4), "bfloat16")
    y = paged_attention_ref(*t)
    assert y.dtype == torch.bfloat16
    assert_close(_np(y), _np(jax_ref(*j)), _TOL["bfloat16"])
    assert_close(_np(y), _np(jax_op(*j)), _TOL["bfloat16"])


@pytest.mark.parametrize("B,K,G,r,nb,bs,maxb,win,span", [
    (3, 2, 2, 16, 16, 4, 7, 0, 4),    # GQA, ragged ctx
    (2, 1, 4, 8, 12, 8, 4, 0, 2),     # MQA
    (3, 2, 3, 16, 16, 4, 7, 5, 3),    # sliding window
])
def test_q_span_matches_jax_and_sequential(B, K, G, r, nb, bs, maxb, win,
                                           span):
    q, kp, vp, table, ctx = _case(B, K, span * G, r, nb, bs, maxb,
                                  inactive_last=False)
    ctx = np.maximum(np.minimum(ctx, (table >= 0).sum(1) * bs - span), 0
                     ).astype(np.int32)
    j, t = _both((q, kp, vp, table, ctx))
    y = paged_attention_ref(*t, window=win, q_span=span)
    assert_close(_np(y), _np(jax_ref(*j, window=win, q_span=span)),
                 _TOL["float32"])
    assert_close(_np(y), _np(jax_op(*j, window=win, q_span=span)),
                 _TOL["float32"])
    # per position, the rows equal a single-position call at ctx + s
    qt, kt, vt, tt, ct = t
    for s in range(span):
        ys = paged_attention_ref(qt[:, :, s * G:(s + 1) * G], kt, vt, tt,
                                 ct + s, window=win)
        assert_close(_np(y[:, :, s * G:(s + 1) * G]), _np(ys),
                     _TOL["float32"])


def test_contiguous_layout_matches_dense_oracle():
    """Blocks laid out contiguously == masked softmax attention over the
    true context (positions 0..ctx inclusive)."""
    B, K, G, r, bs, maxb = 2, 2, 2, 16, 4, 4
    q, kp, vp, _, _ = _case(B, K, G, r, maxb * B, bs, maxb,
                            inactive_last=False)
    table = np.arange(B * maxb, dtype=np.int32).reshape(B, maxb)
    ctx = np.asarray([5, 13], np.int32)
    _, t = _both((q, kp, vp, table, ctx))
    y = paged_attention_ref(*t)
    L = maxb * bs
    kd = kp[table].reshape(B, L, K, r)
    vd = vp[table].reshape(B, L, K, r)
    s = np.einsum("bkgr,btkr->bkgt", q, kd)
    s = np.where((np.arange(L)[None] <= ctx[:, None])[:, None, None], s,
                 -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    assert_close(_np(y), np.einsum("bkgt,btkr->bkgr", p, vd),
                 _TOL["float32"])


@pytest.mark.parametrize("r", [16, 8])     # r == hd, r < hd
def test_fold_q_unfold_o_match_jax(r):
    hd = 16
    rng = np.random.RandomState(1)
    q = rng.standard_normal((2, 2, 2, hd)).astype(np.float32)
    uk = rng.standard_normal((r, hd)).astype(np.float32)
    o = rng.standard_normal((2, 2, 2, r)).astype(np.float32)
    uv = rng.standard_normal((r, hd)).astype(np.float32)
    scale = hd ** -0.5
    assert_close(_np(fold_q(torch.from_numpy(q), torch.from_numpy(uk),
                            scale)),
                 _np(jax_fold_q(jnp.asarray(q), jnp.asarray(uk), scale)))
    assert_close(_np(unfold_o(torch.from_numpy(o), torch.from_numpy(uv))),
                 _np(jax_unfold_o(jnp.asarray(o), jnp.asarray(uv))))
    # dense pools: no link matrices
    np.testing.assert_array_equal(
        _np(fold_q(torch.from_numpy(q), None, 1.0)), q)
    ot = torch.from_numpy(o)
    assert unfold_o(ot, None) is ot


def test_op_raises_like_jax():
    q, kp, vp, table, ctx = _case(2, 2, 6, 8, 8, 4, 4)
    _, t = _both((q, kp, vp, table, ctx))
    with pytest.raises(ValueError, match="q_span"):
        ops.paged_attention_op(*t, q_span=4)
    tz = [torch.zeros(s) for s in ((2, 2, 2, 8), (4, 4, 2, 8),
                                   (4, 4, 2, 4))]
    with pytest.raises(ValueError, match="mismatch"):
        ops.paged_attention_op(*tz, torch.zeros((2, 2), dtype=torch.int32),
                               torch.zeros((2,), dtype=torch.int32))
