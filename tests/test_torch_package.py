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
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import paged_attention as pa_kernel

torch.set_num_threads(1)

_SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_no_jax_and_no_reference_package():
    mods = _all_modules()
    assert len(mods) > 25
    for name in ("serving.server", "serving.scheduler", "serving.runtime",
                 "serving.paged_cache", "serving.sampling",
                 "serving.resilience", "serving.speculative",
                 "testing.chaos", "attention.prefill",
                 "kernels.paged_attention.ops", "obs.metrics", "obs.trace",
                 "obs.export", "obs.loadgen", "obs.slo", "launch.serve",
                 "dist.checkpoint", "serve.engine", "obs.torchprof",
                 "optim.adamw", "dist.compression", "train.train_loop",
                 "core.heal", "core.peft", "zoo", "launch.train",
                 "kernels.flash_attention.backward", "plan.sensitivity",
                 "plan.allocate", "plan.progressive", "roofline.analysis",
                 "launch.plan", "dist.sharding", "dist.elastic",
                 "dist.collectives", "launch.mesh", "launch.specs",
                 "launch.dryrun", "kernels._fake"):
        assert f"repro_torch.{name}" in mods
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
    from repro_torch.launch import plan
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan.main(["--arch", "llama3.1-8b", "--smoke",
                   "--budget-params", "0.5"])
    assert repro_torch.resolve_device("cpu").type == "cpu"
    from repro_torch.launch import serve
    from repro_torch.serving import Server
    assert serve.parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.1-8b", "--smoke"])
    params = init_params(0, get_smoke("llama3.1-8b"), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(params, get_smoke("llama3.1-8b"))


def test_cache_engine_checkpoint_default_to_cuda_and_raise_without_it(
        no_cuda, tmp_path):
    """The dense cache, the checkpoint manager's restore and the serve
    CLI's legacy engine resolve to ``cuda``; the engine and the profiler
    follow their inputs (the prompts' device; the CPU activity and no
    memory snapshot without a card)."""
    from repro_torch.dist import CheckpointManager, TensorSpec
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params
    from repro_torch.obs.torchprof import device_memory_snapshot
    from repro_torch.serve import generate
    cfg = get_smoke("llama3.1-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore({"w": TensorSpec((2,), torch.float32)})
    assert mgr.restore({"w": TensorSpec((2,), torch.float32)},
                       device="cpu")[1]["w"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.1-8b", "--smoke", "--legacy"])
    params = init_params(0, cfg, "cpu")
    out = generate(params, cfg, torch.zeros((1, 4), dtype=torch.long), 2)
    assert out.tokens.device.type == "cpu"
    assert device_memory_snapshot() == {}


def test_placed_serving_defaults_to_cuda_and_raises_without_it(no_cuda):
    """Placed serving resolves its device as the unplaced entry points do:
    the placed dense cache, the placed pool and ``Server(mesh=)`` default
    to ``cuda`` and raise without a card (a 1 x 1 mesh's specs need no
    process group); asked for the CPU, the shards are made there. The dry
    run's fake tensors default to ``cuda`` too."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.serving import PagedConfig, Server
    from repro_torch.serving.paged_cache import init_paged_cache
    mesh = AbstractMesh((1, 1), ("data", "model"))
    cfg = get_smoke("llama3.1-8b")
    pc = PagedConfig(block_size=4, n_blocks=8, max_blocks_per_seq=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8, mesh=mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_cache(cfg, pc, mesh=mesh)
    params = init_params(0, cfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(params, cfg, pc, mesh=mesh)
    cache = init_cache(cfg, 2, 8, "cpu", mesh=mesh)
    pool = init_paged_cache(cfg, pc, "cpu", mesh=mesh)
    for t in repro_torch.bridge.flatten_up_to(cache, cache) + [pool["k"]]:
        assert t.device.type == "cpu"
    assert pool["k"].shape == (cfg.n_layers, 8, 4, cfg.n_kv_heads,
                               cfg.resolved_head_dim)
    assert dryrun.parser().parse_args([]).device == "cuda"


def test_paged_kernel_modes():
    """``off`` is the caller's explicit choice of the plain version on any
    pool; ``auto`` and ``on`` take the kernel for a CUDA pool, and ``on``
    has no CPU route."""
    from repro_torch.attention import registry
    assert registry.resolve_paged(True, "auto").name == "paged_cuda"
    assert registry.resolve_paged(True, "on").name == "paged_cuda"
    assert registry.resolve_paged(True, "off").name == "paged_ref"
    assert registry.resolve_paged(False, "off").name == "paged_ref"
    with pytest.raises(ValueError, match="no interpret mode"):
        registry.resolve_paged(False, "on")
    with pytest.raises(ValueError, match="paged kernel mode"):
        registry.resolve_paged(True, "fast")


class _FakeCuda:
    """Stands in for a CUDA tensor on a machine without one: it reports a
    CUDA device and carries a CPU tensor's shape and dtype."""
    is_cuda = True
    requires_grad = False
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

    def stride(self, *dim):
        return self._t.stride(*dim)

    def to(self, *args, **kwargs):
        return self


def _no_library():
    raise RuntimeError("kernel library unavailable")


def _plain_called(*a, **k):
    raise AssertionError("the plain version ran for a CUDA tensor")


def _fake_called(*a, **k):
    raise AssertionError("the shape-only path ran for a real tensor")


def test_cur_matmul_op_on_cuda_launches_or_raises(monkeypatch):
    monkeypatch.setattr(cm_ops, "cur_matmul_ref", _plain_called)
    monkeypatch.setattr(cm_ops._fake, "cur_matmul", _fake_called)
    monkeypatch.setattr(cm_kernel, "_lib", _no_library)
    before = cm_kernel.launches
    x, cu, r = (_FakeCuda(torch.zeros(s)) for s in
                ((2, 5, 64), (64, 16), (16, 32)))
    with pytest.raises((RuntimeError, AssertionError)) as e:
        cm_ops.cur_matmul_op(x, cu, r)
    assert "plain version" not in str(e.value)
    assert "shape-only" not in str(e.value)
    assert cm_kernel.launches == before


def test_flash_attention_op_on_cuda_launches_or_raises(monkeypatch):
    monkeypatch.setattr(fa_ops, "flash_attention_ref", _plain_called)
    monkeypatch.setattr(fa_ops._fake, "flash_attention", _fake_called)
    monkeypatch.setattr(fa_kernel, "_lib", _no_library)
    before = fa_kernel.launches
    q = _FakeCuda(torch.zeros((1, 4, 32, 16)))
    k = v = _FakeCuda(torch.zeros((1, 2, 32, 16)))
    with pytest.raises((RuntimeError, AssertionError)) as e:
        fa_ops.flash_attention_op(q, k, v)
    assert "plain version" not in str(e.value)
    assert "shape-only" not in str(e.value)
    assert fa_kernel.launches == before


def test_paged_attention_op_on_cuda_launches_or_raises(monkeypatch):
    monkeypatch.setattr(pa_ops, "paged_attention_ref", _plain_called)
    monkeypatch.setattr(pa_ops._fake, "paged_attention", _fake_called)
    monkeypatch.setattr(pa_kernel, "_lib", _no_library)
    before = pa_kernel.launches
    q = _FakeCuda(torch.zeros((2, 2, 2, 16)))
    kp = vp = _FakeCuda(torch.zeros((4, 4, 2, 16)))
    table = _FakeCuda(torch.zeros((2, 3), dtype=torch.int32))
    ctx = _FakeCuda(torch.zeros((2,), dtype=torch.int32))
    with pytest.raises((RuntimeError, AssertionError)) as e:
        pa_ops.paged_attention_op(q, kp, vp, table, ctx)
    assert "plain version" not in str(e.value)
    assert "shape-only" not in str(e.value)
    assert pa_kernel.launches == before


def test_paged_decode_registry_takes_the_kernel_for_cuda():
    from repro_torch.attention import registry
    assert registry.resolve_paged(True).name == "paged_cuda"
    assert registry.resolve_paged(False).name == "paged_ref"


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cm_kernel.cur_matmul(torch.zeros(4, 8), torch.zeros(8, 2),
                             torch.zeros(2, 4))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fa_kernel.flash_attention(torch.zeros(1, 2, 8, 16),
                                  torch.zeros(1, 1, 8, 16),
                                  torch.zeros(1, 1, 8, 16))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        pa_kernel.paged_attention(torch.zeros(2, 1, 2, 8),
                                  torch.zeros(4, 4, 1, 8),
                                  torch.zeros(4, 4, 1, 8),
                                  torch.zeros((2, 2), dtype=torch.int32),
                                  torch.zeros((2,), dtype=torch.int32))


def test_ops_refuse_other_devices():
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cm_ops.cur_matmul_op(x, torch.zeros((8, 2), device="meta"),
                             torch.zeros((2, 4), device="meta"))
    q = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa_ops.flash_attention_op(q, q[:, :1], q[:, :1])
    pool = torch.zeros((4, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pa_ops.paged_attention_op(
            q[0][None], pool, pool,
            torch.zeros((1, 2), dtype=torch.int32, device="meta"),
            torch.zeros((1,), dtype=torch.int32, device="meta"))


def test_kernel_sources_and_build_dir_exist():
    from repro_torch.kernels import _build
    for name in _build.KERNELS:
        assert (_build.SRC_DIR / f"{name}.cu").is_file()
        assert _build.lib_path(name).parent == _build.BUILD_DIR
    assert (_build.SRC_DIR / "hopper.cuh").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_lib_path_hashes_the_headers(tmp_path, monkeypatch):
    """A library is named by its source and every ``csrc/*.cuh`` header,
    so an edited header never loads a stale build."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    first = _build.lib_path("k")
    assert _build.lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build.lib_path("k")
    assert second != first and second.parent == _build.BUILD_DIR
    (tmp_path / "g.cuh").write_text("// another header\n")
    assert _build.lib_path("k") != second
