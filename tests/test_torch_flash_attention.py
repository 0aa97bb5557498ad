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
