"""Port parity: the fused CUR matmul op's plain version (what the port runs
on CPU tensors) against the JAX op (Pallas kernel in interpret mode), over
the JAX suite's case grid (tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cur_matmul.ops import cur_matmul_op as jax_cur_matmul_op
from repro.kernels.cur_matmul.ref import cur_chain_ref as jax_chain_ref
from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
from repro_torch.kernels.cur_matmul.ref import cur_chain_ref, cur_matmul_ref

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _assert_close(y, yr, dtype):
    """Scale-relative max error: 2e-5 f32, 2e-2 bf16 (the JAX suite's)."""
    y = np.asarray(y, np.float32)
    yr = np.asarray(yr, np.float32)
    rel = np.abs(y - yr).max() / (np.abs(yr).max() + 1e-9)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert rel < tol, f"max scaled error {rel} > {tol}"


def _pair(a, dtype):
    """One numpy array as a JAX and a torch tensor of ``dtype``."""
    jd, td = _DT[dtype]
    return jnp.asarray(a, jnp.float32).astype(jd), torch.from_numpy(a).to(td)


def _to_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,m,rk,n", [
    (256, 128, 32, 256),
    (128, 256, 64, 512),
    (512, 64, 16, 128),
    (96, 100, 24, 200),       # ragged M and n
])
def test_cur_matmul_matches_jax(M, m, rk, n, dtype):
    rng = np.random.default_rng(0)
    x, cu, r = (rng.standard_normal(s, dtype=np.float32)
                for s in ((M, m), (m, rk), (rk, n)))
    (jx, tx), (jcu, tcu), (jr, tr) = (_pair(a, dtype) for a in (x, cu, r))
    yj = jax_cur_matmul_op(jx, jcu, jr, bm=128, bn=128)
    yt = cur_matmul_op(tx, tcu, tr)
    assert yt.dtype == _DT[dtype][1] and tuple(yt.shape) == (M, n)
    _assert_close(_to_np(yt), yj, dtype)


def test_cur_matmul_leading_dims_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 16, 128), dtype=np.float32)
    cu = rng.standard_normal((128, 32), dtype=np.float32)
    r = rng.standard_normal((32, 256), dtype=np.float32)
    yj = jax_cur_matmul_op(jnp.asarray(x), jnp.asarray(cu), jnp.asarray(r))
    yt = cur_matmul_op(*(torch.from_numpy(a) for a in (x, cu, r)))
    assert tuple(yt.shape) == (2, 8, 16, 256)
    _assert_close(yt.numpy(), yj, "float32")


def test_cur_matmul_equals_chain():
    """Folded op == unfolded healing-form chain, in both packages."""
    rng = np.random.default_rng(2)
    x, c, u, r = (rng.standard_normal(s, dtype=np.float32)
                  for s in ((64, 96), (96, 16), (16, 16), (16, 80)))
    tx, tc, tu, tr = (torch.from_numpy(a) for a in (x, c, u, r))
    y1 = cur_matmul_op(tx, tc @ tu, tr)
    y2 = cur_chain_ref(tx, tc, tu, tr)
    yj = jax_chain_ref(*(jnp.asarray(a) for a in (x, c, u, r)))
    _assert_close(y1.numpy(), y2.numpy(), "float32")
    _assert_close(y2.numpy(), yj, "float32")


def test_cur_matmul_ref_keeps_f32_intermediate():
    """The plain version keeps x @ CU in f32 (the JAX ref's arithmetic);
    only the output is cast to x's dtype."""
    rng = np.random.default_rng(3)
    x, cu, r = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(torch.bfloat16) for s in ((8, 32), (32, 8), (8, 16)))
    y = cur_matmul_ref(x, cu, r)
    want = ((x.float() @ cu.float()) @ r.float()).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, want)
