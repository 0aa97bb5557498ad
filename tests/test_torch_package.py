"""The port's boundaries: it imports neither jax nor anything of the JAX
package, its entry points never fall back to the CPU on their own, and a
kernel op given a CUDA tensor launches the kernel or raises — it never
takes the plain version."""
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import repro_torch
from repro_torch.configs import get_smoke
from repro_torch.kernels.cur_matmul import cur_matmul as cm_kernel
from repro_torch.kernels.cur_matmul import ops as cm_ops
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

torch.set_num_threads(1)

_SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_no_jax_and_no_reference_package():
    mods = _all_modules()
    assert len(mods) > 25
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print(len(sys.modules))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.launch import cure
    from repro_torch.models import init_params
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(0, get_smoke("llama3.1-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(DataConfig(vocab_size=16, seq_len=4, global_batch=1))
    args = cure.parser().parse_args(["--arch", "llama3.1-8b", "--smoke"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cure.cure(args)
    assert repro_torch.resolve_device("cpu").type == "cpu"


class _FakeCuda:
    """Stands in for a CUDA tensor on a machine without one: it reports a
    CUDA device and carries a CPU tensor's shape and dtype."""
    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t, self.shape, self.dtype = t, t.shape, t.dtype

    def reshape(self, *shape):
        return _FakeCuda(self._t.reshape(*shape))

    def transpose(self, *dims):
        return _FakeCuda(self._t.transpose(*dims))

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    def dim(self):
        return self._t.dim()


def _no_library():
    raise RuntimeError("kernel library unavailable")


def _plain_called(*a, **k):
    raise AssertionError("the plain version ran for a CUDA tensor")


def test_cur_matmul_op_on_cuda_launches_or_raises(monkeypatch):
    monkeypatch.setattr(cm_ops, "cur_matmul_ref", _plain_called)
    monkeypatch.setattr(cm_kernel, "_lib", _no_library)
    before = cm_kernel.launches
    x, cu, r = (_FakeCuda(torch.zeros(s)) for s in
                ((2, 5, 64), (64, 16), (16, 32)))
    with pytest.raises((RuntimeError, AssertionError)) as e:
        cm_ops.cur_matmul_op(x, cu, r)
    assert "plain version" not in str(e.value)
    assert cm_kernel.launches == before


def test_flash_attention_op_on_cuda_launches_or_raises(monkeypatch):
    monkeypatch.setattr(fa_ops, "flash_attention_ref", _plain_called)
    monkeypatch.setattr(fa_kernel, "_lib", _no_library)
    before = fa_kernel.launches
    q = _FakeCuda(torch.zeros((1, 4, 32, 16)))
    k = v = _FakeCuda(torch.zeros((1, 2, 32, 16)))
    with pytest.raises((RuntimeError, AssertionError)) as e:
        fa_ops.flash_attention_op(q, k, v)
    assert "plain version" not in str(e.value)
    assert fa_kernel.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cm_kernel.cur_matmul(torch.zeros(4, 8), torch.zeros(8, 2),
                             torch.zeros(2, 4))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fa_kernel.flash_attention(torch.zeros(1, 2, 8, 16),
                                  torch.zeros(1, 1, 8, 16),
                                  torch.zeros(1, 1, 8, 16))


def test_ops_refuse_other_devices():
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cm_ops.cur_matmul_op(x, torch.zeros((8, 2), device="meta"),
                             torch.zeros((2, 4), device="meta"))
    q = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa_ops.flash_attention_op(q, q[:, :1], q[:, :1])


def test_kernel_sources_and_build_dir_exist():
    from repro_torch.kernels import _build
    for name in _build.KERNELS:
        assert (_build.SRC_DIR / f"{name}.cu").is_file()
        assert _build.lib_path(name).parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
