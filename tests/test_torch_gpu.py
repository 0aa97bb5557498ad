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


def test_apply_w_routes_folded_weights_through_kernel(gen):
    x = _randn(gen, (4, 16, 256), torch.float32)
    w = {"CU": _randn(gen, (256, 32), torch.float32),
         "R": _randn(gen, (32, 384), torch.float32)}
    before = cm.launches
    y = layers.apply_w(x, w)
    assert cm.launches == before + 1
    assert rel_err(y.cpu(), ((x @ w["CU"]) @ w["R"]).cpu()) < 2e-5
