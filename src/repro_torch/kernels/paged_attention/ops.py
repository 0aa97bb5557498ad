"""Public paged-attention decode op: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors. Any other device raises.

The op is forward-only: asked for a gradient (grad mode on and an input
that requires one) it raises rather than return an output with no graph.

Fake tensors (a dry run's) take the shape-only path of ``kernels._fake``,
and only they do.

Dispatch between this op and the plain version is owned by the attention
registry (``repro_torch.attention.registry``, variant ``paged_decode``);
this module is the raw op.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _fake
from repro_torch.kernels.paged_attention import paged_attention as _kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention_op(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor,
                       ctx_len: torch.Tensor, *, window: int = 0,
                       q_span: int = 1) -> torch.Tensor:
    """q (B, K, G', r) folded/pre-scaled -> (B, K, G', r). ``q_span`` > 1
    is the multi-position speculative-verify layout."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pool, v_pool)):
        raise RuntimeError(
            "paged_attention_op has no backward: it takes no input that "
            "requires grad")
    _kernel.check_shapes(q, k_pool, v_pool, table, ctx_len, q_span)
    if _fake.is_fake(q, k_pool, v_pool, table, ctx_len):
        return _fake.paged_attention(q, k_pool, v_pool, table, ctx_len,
                                     window)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, table, ctx_len,
                                   window=window, q_span=q_span)
    if q.device.type == "cuda":
        return _kernel.paged_attention(q, k_pool, v_pool, table, ctx_len,
                                       window=window, q_span=q_span)
    raise ValueError(f"paged_attention_op: no kernel for {q.device}")
