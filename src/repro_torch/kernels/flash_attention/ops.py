"""Public flash attention op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors. Any other device raises.

On the card the kernel runs inside ``FlashAttentionFn``, an autograd
function whose backward is :func:`flash_attention_bwd` (PyTorch ops), so
gradients reach q, k and v; the kernel's ctypes launch alone would give an
output with no graph. On the CPU the plain version is differentiable as
it is.

Fake tensors (a dry run's) take the shape-only path of
``kernels._fake`` inside ``FlashAttentionFn``, and only they do.

Dispatch between this op and the plain backends is owned by the attention
registry (``repro_torch.attention.registry``); this module is the raw op.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _fake
from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


class FlashAttentionFn(torch.autograd.Function):
    """Forward: the hand kernel, unchanged. Backward: the plain
    :func:`flash_attention_bwd` from the saved q, k, v and output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        if _fake.is_fake(q, k, v):
            o = _fake.flash_attention(q, k, v, window)
        else:
            o = _kernel.flash_attention(q, k, v, causal=causal,
                                        window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """``scale=None`` uses 1/sqrt(d). The rank-space prefill path passes
    an explicit scale (folded queries already carry it, so it passes 1.0)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type == "cuda":
        if scale is None:
            scale = q.shape[-1] ** -0.5
        return FlashAttentionFn.apply(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal, window,
                                      float(scale))
    raise ValueError(f"flash_attention_op: no kernel for {q.device}")
