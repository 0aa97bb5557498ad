"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``).

The traces run in processes of their own (a fake default process group
must not outlive its process, nor reach the other tests of an xdist
worker): tests/_torch_dryrun_worker.py on a fake (2, 4) and (1, 4) mesh,
tests/_jax_dryrun_ref.py on 8 host devices, with the cases of
tests/_dryrun_cases.py. The port's fake tensors lie on the CPU there (this
host's PyTorch has no CUDA); the card's route is traced on the card
(chip_smoke.py phase 14d).

  - per-rank argument bytes of SMOKE train / prefill / decode / paged
    cells (with and without structural CUR) equal JAX's
    ``memory_analysis().argument_size_in_bytes`` of the same jitted cells;
  - the two-point extrapolated FLOPs, essential bytes, all-op bytes and
    collective bytes equal the direct counts exactly (olmo-1b's and
    jamba's SMOKEs);
  - a TP-only (1 x 4) SMOKE forward records the Megatron collectives;
  - ``Roofline``'s four properties equal JAX's on the same inputs;
  - the CLI on the 16 x 16 fake mesh writes JAX's keys;
  - the kernels' shape-only paths take fake tensors only.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.roofline.analysis as jroof
from repro_torch.roofline import analysis as troof

import _dryrun_cases as dc

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "src")

# repro/launch/dryrun.py lower_cell's result keys
JAX_KEYS = (
    "arch", "shape", "mesh", "cur", "paged", "spec_k", "status",
    "cost_basis", "lower_s", "compile_s", "compile_extra_s",
    "argument_gib_per_dev", "temp_gib_per_dev", "output_gib_per_dev",
    "flops_per_dev", "raw_scanned_flops_per_dev", "bytes_per_dev",
    "bytes_xla_per_dev", "coll_bytes_per_dev", "coll_detail",
    "model_flops", "compute_s", "memory_s", "collective_s", "dominant",
    "useful_flop_ratio", "roofline_fraction")


def _env(**kw):
    return dict(os.environ, PYTHONPATH=_SRC, OMP_NUM_THREADS="1", **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    port = subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "_torch_dryrun_worker.py"),
         str(tmp / "port.pkl")], env=_env(), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    ref = subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "_jax_dryrun_ref.py"),
         str(tmp / "jax.pkl")], env=_env(
             JAX_PLATFORMS="cpu",
             XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        for proc, what in ((port, "port"), (ref, "JAX reference")):
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{what}:\n{out}\n{err[-4000:]}"
    finally:
        for proc in (port, ref):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    with open(tmp / "port.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    return got, want


@pytest.mark.parametrize("case", dc.ARG_CELLS, ids=lambda c: "-".join(
    str(x) for x in c))
def test_argument_bytes_match_jax(run, case):
    got, want = run
    cell = got["args"][case]
    assert cell["status"] == "OK"
    assert cell["argument_bytes_per_dev"] == want[case] > 0
    assert cell["argument_gib_per_dev"] == round(want[case] / 2**30, 3)


@pytest.mark.parametrize("case", dc.EXTRAP_CELLS, ids=lambda c: "-".join(
    str(x) for x in c))
def test_extrapolated_counts_equal_direct(run, case):
    ext, direct = run[0]["extrap"][case]
    assert ext["cost_basis"] == "2pt-extrapolated-unrolled-static"
    assert direct["cost_basis"] == "direct"
    for key in ("flops_per_dev", "bytes_per_dev", "bytes_xla_per_dev",
                "coll_bytes_per_dev", "coll_detail"):
        assert ext[key] == direct[key], key
    assert direct["flops_per_dev"] > 0 and direct["bytes_per_dev"] > 0


def test_tp_forward_records_the_megatron_collectives(run):
    """olmo's SMOKE (3 layers, d_model 64, vocab 256, f32, tied
    embeddings) on a (1, 4) mesh, B 2 x S 8: the vocab-sharded
    embedding's sum and each layer's two row-parallel outputs (wo,
    w_down) all-reduce a (B, S, D) activation; the vocab-sharded logits
    (B, S, V / 4) are all-gathered once. Nothing else moves."""
    arch, B, S = dc.TP_FORWARD
    L, D, V, n, es = 3, 64, 256, 4, 4
    act = B * S * D * es
    want = {"all-gather": B * S * (V // n) * es, "all-reduce": (1 + 2 * L)
            * act, "reduce-scatter": 0, "all-to-all": 0,
            "collective-permute": 0, "count": 2 + 2 * L}
    want["total"] = want["all-gather"] + want["all-reduce"]
    assert run[0]["tp"] == want


@pytest.mark.parametrize("terms", [(1e12, 2e11, 4e9), (3e9, 5e12, 1e8),
                                   (1e6, 1e6, 9e12), (0.0, 0.0, 0.0)])
def test_roofline_properties_match_jax(monkeypatch, terms):
    """The same inputs (and JAX's peak rate, the one constant the
    properties read) give JAX's dominant term, step time, useful-FLOP
    ratio and roofline fraction."""
    monkeypatch.setattr(troof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    flops, nbytes, coll = terms
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256,
              flops_per_device=flops, bytes_per_device=nbytes,
              coll_bytes_per_device=coll, model_flops_global=1e14,
              compute_s=flops / 197e12, memory_s=nbytes / 819e9,
              collective_s=coll / 50e9, peak_mem_bytes=1, coll_detail={})
    t, j = troof.Roofline(**kw), jroof.Roofline(**kw)
    for prop in ("dominant", "step_time_s", "useful_flop_ratio",
                 "roofline_fraction"):
        assert getattr(t, prop) == getattr(j, prop), prop


def test_link_rate_is_the_ndr_links():
    assert troof.LINK_BW == 50e9


def test_cli_writes_jax_keys(tmp_path):
    """``--arch olmo-1b --shape decode_32k --paged --out F`` on the 16 x
    16 fake mesh (its fake tensors on the CPU here): one OK cell with
    every key of the JAX package's record, no card touched."""
    out = tmp_path / "cells.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo-1b", "--shape", "decode_32k", "--paged", "--out", str(out),
         "--device", "cpu"], env=_env(), text=True, capture_output=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    cells = json.loads(out.read_text())
    assert len(cells) == 1
    cell = cells[0]
    assert cell["status"] == "OK", cell
    assert set(JAX_KEYS) <= set(cell)
    assert cell["mesh"] == "16x16"
    assert cell["cost_basis"] == "2pt-extrapolated-unrolled-static"
    assert cell["host_inputs"] == ["table", "ctx_len", "active"]
    assert set(cell["coll_detail"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "count", "total"}
    assert cell["dominant"] in ("compute", "memory", "collective")
    device = json.loads(res.stdout.strip().splitlines()[-1].split(
        "device: ", 1)[1])
    assert device == {"cuda_initialized": False, "memory_allocated": 0,
                      "memory_reserved": 0,
                      "launches": {"cur_matmul": 0, "flash_attention": 0,
                                   "paged_attention": 0}}


# ---------------------------------------------------------------------------
# the kernels' shape-only paths
# ---------------------------------------------------------------------------

def _kernel_inputs(make):
    """(cur_matmul, flash_attention, paged_attention) argument tuples made
    by ``make(shape, dtype)``."""
    f32, i32 = torch.float32, torch.int32
    cur = (make((6, 128), f32), make((128, 16), f32), make((16, 128), f32))
    flash = (make((1, 4, 8, 16), f32), make((1, 2, 8, 16), f32),
             make((1, 2, 8, 16), f32))
    paged = (make((2, 2, 3, 8), f32), make((6, 4, 2, 8), f32),
             make((6, 4, 2, 8), f32), make((2, 3), i32), make((2,), i32))
    return cur, flash, paged


def _fakes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()

    def make(shape, dtype):
        with mode:
            return torch.empty(shape, dtype=dtype)
    return mode, make


def test_fake_branches_refuse_real_tensors():
    """A real tensor never runs the shape-only path: handed to it
    directly, it raises; through the ops, real CPU tensors take the
    plain versions and note nothing."""
    from repro_torch.kernels import _fake
    from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
    from repro_torch.kernels.cur_matmul.ref import cur_matmul_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention_op
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    gen = torch.Generator().manual_seed(0)

    def real(shape, dtype):
        if dtype == torch.int32:
            return torch.randint(0, 3, shape, generator=gen,
                                 dtype=dtype).clamp(max=5)
        return torch.randn(shape, generator=gen, dtype=dtype)

    cur, flash, paged = _kernel_inputs(real)
    paged = paged[:3] + (torch.tensor([[0, 1, 2], [3, 4, 5]],
                                      dtype=torch.int32),
                         torch.tensor([9, 5], dtype=torch.int32))
    with pytest.raises(TypeError):
        _fake.cur_matmul(*cur)
    with pytest.raises(TypeError):
        _fake.flash_attention(*flash, 0)
    with pytest.raises(TypeError):
        _fake.paged_attention(*paged, 0)
    with _fake.recording() as rec:
        assert torch.equal(cur_matmul_op(*cur), cur_matmul_ref(*cur))
        assert torch.equal(flash_attention_op(*flash),
                           flash_attention_ref(*flash))
        assert torch.equal(paged_attention_op(*paged),
                           paged_attention_ref(*paged))
    assert rec == []
    mode, make = _fakes()
    fake_cur = _kernel_inputs(make)[0]
    with pytest.raises(TypeError):          # one real input among fakes
        _fake.cur_matmul(fake_cur[0], cur[1], fake_cur[2])


def test_fake_branches_note_the_bound_formulas():
    """Fake inputs: an empty output of the kernel's shape, no launch, and
    the FLOPs and bytes of chip_smoke.py's bound formulas."""
    from repro_torch.kernels import _fake
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ops import paged_attention_op
    _, make = _fakes()
    cur, flash, paged = _kernel_inputs(make)
    before = (cm.launches, fa.launches, pa.launches)
    with _fake.recording() as rec:
        y = cur_matmul_op(*cur)
        o = _fake.flash_attention(*flash, window=3)
        p = paged_attention_op(*paged, q_span=3)
    assert (cm.launches, fa.launches, pa.launches) == before
    assert y.shape == (6, 128) and o.shape == flash[0].shape
    assert p.shape == paged[0].shape
    M, m, r, n = 6, 128, 16, 128
    B, H, K, S, d = 1, 4, 2, 8, 16
    pairs = sum(min(i + 1, 3) for i in range(S))
    Bp, Kp, G, rp, live = 2, 2, 3, 8, 2 * 2 * 3 * 4
    assert rec == [
        ("cur_matmul", 2 * M * r * (m + n), 4 * (M * m + m * r + r * n
                                                + M * n)),
        ("flash_attention", 4 * B * H * d * pairs,
         4 * (2 * B * H * S * d + 2 * B * K * S * d)),
        ("paged_attention", 4 * live * G * rp,
         4 * (2 * live * rp + 2 * Bp * Kp * G * rp))]
    assert _fake.live_pairs(S, 3) == pairs
    assert _fake.live_pairs(S, 0) == S * (S + 1) // 2 == _fake.live_pairs(
        S, 100)


def test_collectives_record_off_by_default():
    from repro_torch.dist import collectives as col
    assert col._RECORD is None
    with col.recording() as rec:
        assert col._RECORD is rec
        assert set(rec) == set(col.COLLECTIVES) | {"count", "total"}
    assert col._RECORD is None
    np.testing.assert_array_equal(list(rec.values()), 0)
