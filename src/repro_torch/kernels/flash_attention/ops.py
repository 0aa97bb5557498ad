"""Public flash attention op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors. Any other device raises.

Dispatch between this op and the plain backends is owned by the attention
registry (``repro_torch.attention.registry``); this module is the raw op.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """``scale=None`` uses 1/sqrt(d). The rank-space prefill path passes
    an explicit scale (folded queries already carry it, so it passes 1.0)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type == "cuda":
        return _kernel.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, scale=scale)
    raise ValueError(f"flash_attention_op: no kernel for {q.device}")
