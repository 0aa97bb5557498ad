"""Attention-backend registry of the port: the ``mix`` variant.

``mix`` is full-sequence attention over in-flight K/V (forward,
calibration, evaluation). Backends in resolution order, as in the JAX
package:

  ``flash_cuda``  the hand-written CUDA kernel, for CUDA tensors
  ``dense``       the dense masked softmax (oracle; S <= ``DENSE_MAX``)
  ``banded``      chunked sliding window (window > 0)
  ``flash``       chunked online softmax (the fallback)

The paged variants wait for the serving slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.attention import xla


@dataclasses.dataclass(frozen=True)
class Caps:
    """What a backend can express (resolution filters on these)."""
    window: bool = False       # sliding-window masking


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    caps: Caps
    fn: Callable
    available: Callable[[dict], bool] = lambda ctx: True


_REGISTRY: Dict[str, List[Backend]] = {}


def register(variant: str, backend: Backend) -> Backend:
    _REGISTRY.setdefault(variant, []).append(backend)
    return backend


def resolve(variant: str, **ctx) -> Backend:
    """First registered backend whose caps cover the request and whose
    availability gate passes. ``ctx`` keys: seq_len, window, on_cuda,
    dense_max."""
    cands = _REGISTRY.get(variant)
    if not cands:
        raise KeyError(f"unknown attention variant {variant!r}")
    for be in cands:
        if ctx.get("window", 0) > 0 and not be.caps.window:
            continue
        if be.available(ctx):
            return be
    raise LookupError(f"no available backend for {variant!r} with {ctx}")


def _mix_flash_cuda(q, k, v, q_pos, kv_pos, window, scale, *, chunk):
    """(B,S,K,G,d) grouped queries -> the kernel's (B,H,S,d) layout and
    back. Positions are contiguous from 0 at every call site."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    B, S, K, G, d = q.shape
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, d)
    o = flash_attention_op(qh, k.transpose(1, 2), v.transpose(1, 2),
                           causal=True, window=window, scale=scale)
    return o.reshape(B, K, G, S, d).permute(0, 3, 1, 2, 4)


def _mix_dense(q, k, v, q_pos, kv_pos, window, scale, *, chunk):
    return xla.dense_attn(q, k, v, q_pos, kv_pos, window, scale)


def _mix_banded(q, k, v, q_pos, kv_pos, window, scale, *, chunk):
    return xla.banded_attn(q, k, v, q_pos, kv_pos, window, scale, chunk)


def _mix_flash(q, k, v, q_pos, kv_pos, window, scale, *, chunk):
    return xla.flash_attn(q, k, v, q_pos, kv_pos, scale, chunk)


register("mix", Backend(
    "flash_cuda", Caps(window=True), _mix_flash_cuda,
    available=lambda ctx: ctx.get("on_cuda", False)))
register("mix", Backend(
    "dense", Caps(window=True), _mix_dense,
    available=lambda ctx: (ctx.get("seq_len", 0)
                           <= ctx.get("dense_max", xla.DENSE_MAX))))
register("mix", Backend(
    "banded", Caps(window=True), _mix_banded,
    available=lambda ctx: ctx.get("window", 0) > 0))
register("mix", Backend("flash", Caps(window=False), _mix_flash))


def mix(qg, k, v, positions, window: int, scale: float, cfg=None, *,
        dense_max: Optional[int] = None):
    """Resolve and run the ``mix`` variant.

    qg (B,S,K,G,d) grouped queries; k,v (B,S,K,d); positions (B,S)."""
    S = qg.shape[1]
    chunk = cfg.attn_chunk if cfg is not None else xla.CHUNK
    be = resolve("mix", seq_len=S, window=window, on_cuda=qg.is_cuda,
                 dense_max=dense_max if dense_max is not None
                 else xla.DENSE_MAX)
    return be.fn(qg, k, v, positions, positions, window, scale, chunk=chunk)
