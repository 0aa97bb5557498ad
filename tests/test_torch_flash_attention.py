"""Port parity: the flash attention op's plain version (what the port runs
on CPU tensors) against the JAX op (Pallas kernel in interpret mode) at an
explicit scale, over the JAX suite's case grid (tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention_op as jax_flash_op)
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _assert_close(y, yr, dtype):
    y = np.asarray(y, np.float32)
    yr = np.asarray(yr, np.float32)
    rel = np.abs(y - yr).max() / (np.abs(yr).max() + 1e-9)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert rel < tol, f"max scaled error {rel} > {tol}"


def _qkv(B, H, K, S, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, H, S, d), (B, K, S, d), (B, K, S, d))]
    jd, td = _DT[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,d,win", [
    (1, 4, 2, 128, 32, 0),
    (2, 4, 4, 64, 16, 0),      # MHA
    (1, 8, 1, 128, 32, 0),     # MQA
    (1, 4, 2, 128, 32, 48),    # sliding window
    (1, 2, 2, 64, 64, 16),
    (1, 4, 1, 96, 256, 0),     # gemma3's head dim, MQA
    (1, 4, 1, 128, 256, 40),   # d 256 with a window
])
def test_flash_attention_matches_jax(B, H, K, S, d, win, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, H, K, S, d, dtype, 3)
    scale = 0.7 * d ** -0.5
    yj = jax_flash_op(jq, jk, jv, window=win, bq=32, bk=32, scale=scale)
    yt = flash_attention_op(tq, tk, tv, window=win, scale=scale)
    assert yt.dtype == _DT[dtype][1] and yt.shape == tq.shape
    _assert_close(yt.float().numpy(), yj, dtype)


@pytest.mark.parametrize("S,bq,bk,causal", [
    (100, 32, 32, True),       # ragged: pads to 128
    (72, 32, 16, False),       # non-causal — padded keys must be masked
    (130, 64, 64, True),       # just over two tiles
])
def test_flash_attention_ragged_matches_jax(S, bq, bk, causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 4, 2, S, 16, "float32", 7)
    yj = jax_flash_op(jq, jk, jv, causal=causal, bq=bq, bk=bk, scale=0.25)
    yt = flash_attention_op(tq, tk, tv, causal=causal, scale=0.25)
    assert yt.shape == tq.shape
    _assert_close(yt.numpy(), yj, "float32")


def test_flash_attention_default_scale_is_inverse_sqrt_d():
    _, (tq, tk, tv) = _qkv(1, 4, 2, 32, 16, "float32", 9)
    a = flash_attention_op(tq, tk, tv)
    b = flash_attention_op(tq, tk, tv, scale=16 ** -0.5)
    assert torch.equal(a, b)


def test_flash_attention_gqa_mismatch_raises():
    q = torch.zeros((1, 6, 32, 8))
    k = v = torch.zeros((1, 4, 32, 8))
    with pytest.raises(ValueError, match="GQA"):
        flash_attention_op(q, k, v)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention_ref(q, k, v)


@pytest.mark.parametrize("d", [8, 24, 48])
def test_registry_adaptor_pads_feature_dim(d):
    """The ``flash_cuda`` adaptor zero-pads a feature dim between the
    kernel's widths (a CUR-KV rank) and slices back: on CPU tensors, where
    the op is the plain version, it equals the unpadded plain path and the
    JAX op at the same d."""
    from repro_torch.attention import registry
    B, S, K, G = 2, 40, 2, 2
    (jq, jk, jv), (q, k, v) = _qkv(B, K * G, K, S, d, "float32", seed=d)
    qg = q.reshape(B, K, G, S, d).permute(0, 3, 1, 2, 4)
    pos = torch.arange(S)[None].expand(B, S)
    o = registry._mix_flash_cuda(qg, k.transpose(1, 2), v.transpose(1, 2),
                                 pos, pos, 0, 1.0, chunk=0)
    o = o.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, d)
    _assert_close(o.numpy(),
                  flash_attention_ref(q, k, v, scale=1.0).numpy(), "float32")
    _assert_close(o.numpy(), np.asarray(jax_flash_op(jq, jk, jv, scale=1.0)),
                  "float32")
    assert registry._padded_dim(d) in (16, 32, 64)


def test_registry_adaptor_refuses_dims_above_the_kernel():
    """d 129 .. 256 pad to the kernel's widest width, 256 (gemma3's head
    dim); above it the adaptor raises."""
    from repro_torch.attention import registry
    assert registry._padded_dim(128) == 128
    assert registry._padded_dim(129) == registry._padded_dim(256) == 256
    with pytest.raises(ValueError, match="above 256"):
        registry._padded_dim(257)


@pytest.mark.parametrize("d", [160, 256])
def test_registry_adaptor_at_head_dim_256(d):
    """The adaptor at gemma3's head dim (exact) and at a width padded up
    to it, on CPU tensors (the plain version), against the JAX op."""
    from repro_torch.attention import registry
    B, S, K, G = 1, 48, 1, 4
    (jq, jk, jv), (q, k, v) = _qkv(B, K * G, K, S, d, "float32", seed=d)
    qg = q.reshape(B, K, G, S, d).permute(0, 3, 1, 2, 4)
    pos = torch.arange(S)[None].expand(B, S)
    o = registry._mix_flash_cuda(qg, k.transpose(1, 2), v.transpose(1, 2),
                                 pos, pos, 16, d ** -0.5, chunk=0)
    o = o.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, d)
    _assert_close(o.numpy(), np.asarray(jax_flash_op(
        jq, jk, jv, window=16, scale=d ** -0.5)), "float32")
    assert registry._padded_dim(d) == 256
