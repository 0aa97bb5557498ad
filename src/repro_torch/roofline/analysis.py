"""Roofline costs of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data
sheet:

  PEAK_FLOPS = 989e12   dense bf16 tensor-core FLOP/s
  HBM_BW     = 3.35e12  HBM3 bytes/s

A product's roofline latency is the larger of its FLOPs over the peak and
its weight bytes over the memory rate. ``cur_latency_s`` is the
per-weight cost model of ``repro_torch.plan``'s latency budget;
``model_flops`` counts a model's useful FLOPs for a workload shape.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card


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
