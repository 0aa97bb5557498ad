"""Roofline costs of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data
sheets:

  PEAK_FLOPS = 989e12   dense bf16 tensor-core FLOP/s
  HBM_BW     = 3.35e12  HBM3 bytes/s
  LINK_BW    = 50e9     bytes/s of the card's InfiniBand NDR link (400 Gb/s)

A product's roofline latency is the larger of its FLOPs over the peak and
its weight bytes over the memory rate. ``cur_latency_s`` is the
per-weight cost model of ``repro_torch.plan``'s latency budget;
``model_flops`` counts a model's useful FLOPs for a workload shape.

The dry run's terms (``repro_torch.launch.dryrun``; the JAX package's
``roofline.analysis`` reads them from compiled HLO): :func:`recording`
counts one traced step on fake tensors, and :func:`collective_bytes`,
:func:`essential_bytes` and :func:`analyze` read its record:

  compute_s    = FLOPs per rank / PEAK_FLOPS
  memory_s     = essential bytes per rank / HBM_BW
  collective_s = collective operand bytes per rank / LINK_BW

FLOPs are ``FlopCounterMode``'s count of the aten ops plus the FLOPs the
three kernels' shape-only paths note (``repro_torch.kernels._fake``).
Essential bytes are the operand and result bytes of the matmul-class,
embedding / gather / scatter / index and reduction ops and of the
collectives, plus the kernels' HBM bytes; elementwise ops are skipped, as
the JAX package's count assumes them fused into their producers'
epilogues. ``LINK_BW`` is one constant, as JAX has one ICI rate: at rank
= data * 16 + model a 16-wide 'model' group spans two 8-card nodes, so its
collectives cross the InfiniBand link; inside a node NVLink 4 moves 450e9
bytes/s each way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 50e9               # bytes/s per card, InfiniBand NDR (400 Gb/s)


def gemm_latency_s(m: int, n: int, *, dtype_bytes: int = 2,
                   batch: int = 1) -> float:
    """Single-card roofline latency of x (batch, m) @ W (m, n): the max of
    the compute and weight-HBM-traffic terms. At decode batch sizes the
    memory term dominates — weight bytes stream once per step."""
    flops = 2.0 * batch * m * n
    mem = float(m) * n * dtype_bytes
    return max(flops / PEAK_FLOPS, mem / HBM_BW)


def cur_latency_s(m: int, n: int, r: int, *, dtype_bytes: int = 2,
                  batch: int = 1, folded: bool = True) -> float:
    """Roofline latency of the CUR matmul chain replacing a dense (m, n)
    weight: x @ CU (m, r) then @ R (r, n) when folded, with the extra
    (r, r) link hop otherwise."""
    t = gemm_latency_s(m, r, dtype_bytes=dtype_bytes, batch=batch)
    if not folded:
        t += gemm_latency_s(r, r, dtype_bytes=dtype_bytes, batch=batch)
    return t + gemm_latency_s(r, n, dtype_bytes=dtype_bytes, batch=batch)


def model_flops(cfg, shape) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (prefill/decode)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch      # decode: one token a sequence


# ---------------------------------------------------------------------------
# the dry run's record
# ---------------------------------------------------------------------------

# aten ops whose operand and result bytes count as HBM traffic: matmuls,
# embedding / gather / scatter / index ops, reductions (and softmaxes,
# which reduce), sorts
_ESSENTIAL = frozenset((
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "linear", "dot",
    "convolution", "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
    "embedding", "embedding_dense_backward", "index_select", "gather",
    "scatter", "scatter_add", "scatter_reduce", "index", "index_put",
    "index_put_", "index_add", "index_add_", "index_copy", "take",
    "take_along_dim", "masked_scatter",
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "logsumexp", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum", "cumprod", "prod", "norm",
    "linalg_vector_norm", "var", "std", "var_mean", "sort", "topk", "any",
    "all"))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _device_tensors(tree):
    """The fake tensors of ``tree`` (the traced device work's; real host
    tensors and shape-only ``meta`` stand-ins are not counted)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return [t for t in tree_leaves(tree) if isinstance(t, FakeTensor)
            and t.device.type != "meta"]


class _Tally(TorchDispatchMode):
    """Essential bytes of the traced ops (see the module docstring) and
    the live bytes of the fake tensors made inside the mode, with their
    peak. Real (host) tensors are not counted."""

    def __init__(self):
        super().__init__()
        self.essential = 0
        self.accessed = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def _free(self, key):
        ent = self._refs[key]
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._refs[key]

    def _track(self, t, in_keys):
        key = t.untyped_storage()._cdata
        ent = self._refs.get(key)
        if ent is None:
            if key in in_keys:     # a view or in-place result of a storage
                return             # made before the block: no new bytes
            ent = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "aten" and not func.is_view:
            moved = sum(_nbytes(t) for t in _device_tensors(
                (args, kwargs, out)))
            self.accessed += moved
            if name in _ESSENTIAL:
                self.essential += moved
        elif ns == "c10d":
            moved = sum(_nbytes(t) for t in _device_tensors((args, kwargs)))
            # an all-reduce writes its operand back: operand + result
            self.essential += 2 * moved if name.startswith("allreduce") \
                else moved
        outs = _device_tensors(out)
        with torch.utils._python_dispatch._disable_current_modes():
            in_keys = {t.untyped_storage()._cdata
                       for t in _device_tensors((args, kwargs))}
            for t in outs:
                self._track(t, in_keys)
        return out


@contextlib.contextmanager
def recording():
    """Counts the device work of the block (a step traced on fake
    tensors): yields a dict that holds, once the block ends, ``flops``
    (aten + kernels), ``essential_bytes``, ``collectives`` (JAX's
    ``collective_bytes`` keys), ``kernels`` ({name: {calls, flops,
    bytes}}), ``temp_peak_bytes`` (the peak of the live bytes of the
    device tensors made inside the block) and ``accessed_bytes`` (every
    device op's operand and result bytes, nothing fused: the analogue of
    XLA's "bytes accessed")."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import collectives as col
    from repro_torch.kernels import _fake
    rec: dict = {}
    tally = _Tally()
    with col.recording() as coll, _fake.recording() as kern:
        with FlopCounterMode(display=False) as fc, tally:
            yield rec
    kernels: Dict[str, Dict[str, int]] = {}
    for name, flops, nbytes in kern:
        k = kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
    kbytes = sum(k["bytes"] for k in kernels.values())
    rec.update(
        flops=float(fc.get_total_flops()
                    + sum(k["flops"] for k in kernels.values())),
        essential_bytes=tally.essential + kbytes,
        accessed_bytes=tally.accessed + kbytes,
        collectives=dict(coll), kernels=kernels,
        temp_peak_bytes=tally.peak)


def collective_bytes(record) -> Dict[str, int]:
    """Per-opcode collective payload bytes (operand side) of a record,
    with ``count`` and ``total`` (the JAX package's keys)."""
    return dict(record["collectives"])


def essential_bytes(record) -> int:
    """The record's essential HBM bytes (see the module docstring)."""
    return int(record["essential_bytes"])


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_global: float
    compute_s: float
    memory_s: float
    collective_s: float
    peak_mem_bytes: int
    coll_detail: Dict[str, int]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (perfectly-overlapped) step time: max of the terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        hw = self.flops_per_device * self.chips
        return self.model_flops_global / hw if hw else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS utilization at the optimistic step time:
        model_flops / (step_time * chips * peak)."""
        denom = self.step_time_s * self.chips * PEAK_FLOPS
        return self.model_flops_global / denom if denom else 0.0


def analyze(record, cfg, shape, mesh_name: str, chips: int, arch: str,
            peak_mem_bytes: int = 0,
            model_flops_global: Optional[float] = None) -> Roofline:
    """The roofline of one traced step's ``record`` (per rank; any dict
    with its ``flops``, ``essential_bytes`` and ``collectives``).
    ``model_flops_global`` defaults to :func:`model_flops`."""
    flops = float(record["flops"])
    nbytes = float(essential_bytes(record))
    coll = collective_bytes(record)
    if model_flops_global is None:
        model_flops_global = model_flops(cfg, shape)
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=nbytes,
        coll_bytes_per_device=float(coll["total"]),
        model_flops_global=model_flops_global,
        compute_s=flops / PEAK_FLOPS, memory_s=nbytes / HBM_BW,
        collective_s=coll["total"] / LINK_BW,
        peak_mem_bytes=peak_mem_bytes, coll_detail=coll)
