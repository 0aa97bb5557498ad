"""Attention-backend registry of the port.

Variants and their backends in resolution order, as in the JAX package:

  ``mix``            full-sequence attention over in-flight K/V (forward,
                     prefill, calibration, evaluation):
      ``flash_cuda``  the hand-written CUDA kernel, for CUDA tensors (the
                      feature dim is zero-padded up to a kernel width)
      ``dense``       the dense masked softmax (oracle; S <= ``DENSE_MAX``)
      ``banded``      chunked sliding window (window > 0)
      ``flash``       chunked online softmax (the fallback)
  ``paged_decode``   queries against the block-table pool, in rank space:
      ``paged_cuda``  the hand-written CUDA kernel, for CUDA tensors
      ``paged_ref``   the gather-based plain version, for CPU tensors
  ``paged_prefill``  prompt attention + pool payload for CUR-KV pools
                     (``rank_fold``, then the ``reconstruct`` oracle;
                     registered by ``repro_torch.attention``)

The choice depends only on where the tensors lie: the port has no
environment switches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.attention import xla
from repro_torch.kernels.paged_attention.ref import (     # noqa: F401
    fold_q, unfold_o)


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


def _padded_dim(d: int) -> int:
    """The smallest kernel width >= d; d above the largest raises."""
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
    for w in HEAD_DIMS:
        if d <= w:
            return w
    raise ValueError(f"flash_attention: head dim {d} above {HEAD_DIMS[-1]}")


def _mix_flash_cuda(q, k, v, q_pos, kv_pos, window, scale, *, chunk):
    """(B,S,K,G,d) grouped queries -> the kernel's (B,H,S,d) layout and
    back. Positions are contiguous from 0 at every call site. A feature
    dim between the kernel's widths (a CUR-KV rank r) is zero-padded up to
    the next one and the output sliced back: zero columns add nothing to
    the scores, and ``scale`` is passed explicitly, so this is exact. The
    pad, permutes and slice are differentiable: under autograd the padded
    columns get zero gradient and are sliced off."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    B, S, K, G, d = q.shape
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, d)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    dp = _padded_dim(d)
    if dp != d:
        pad = (0, dp - d)
        qh, kh, vh = (torch.nn.functional.pad(t, pad) for t in (qh, kh, vh))
    o = flash_attention_op(qh, kh, vh, causal=True, window=window,
                           scale=scale)
    return o[..., :d].reshape(B, K, G, S, d).permute(0, 3, 1, 2, 4)


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


# ---------------------------------------------------------------------------
# paged_decode variant: queries against the block-table pool (rank space)
# ---------------------------------------------------------------------------

def _paged_cuda(qf, k_pool, v_pool, table, ctx_len, *, window, q_span):
    from repro_torch.kernels.paged_attention.ops import paged_attention_op
    return paged_attention_op(qf, k_pool, v_pool, table, ctx_len,
                              window=window, q_span=q_span)


def _paged_ref(qf, k_pool, v_pool, table, ctx_len, *, window, q_span):
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    return paged_attention_ref(qf, k_pool, v_pool, table, ctx_len,
                               window=window, q_span=q_span)


register("paged_decode", Backend(
    "paged_cuda", Caps(window=True), _paged_cuda,
    available=lambda ctx: ctx.get("on_cuda", False)))
register("paged_decode", Backend("paged_ref", Caps(window=True), _paged_ref))


PAGED_KERNEL_MODES = ("auto", "on", "off")


def resolve_paged(on_cuda: bool, mode: str = "auto") -> Backend:
    """The ``paged_decode`` backend for a pool on a CUDA device or not.

    ``mode`` is the caller's explicit choice (serve's ``--paged-kernel``):
    "auto" and "on" take the kernel for a CUDA pool; "off" takes the plain
    version ``paged_ref`` wherever the pool lies; "on" for a pool off the
    card raises, since the port's kernel has no interpret mode."""
    if mode not in PAGED_KERNEL_MODES:
        raise ValueError(f"paged kernel mode must be one of "
                         f"{PAGED_KERNEL_MODES}, got {mode!r}")
    if mode == "off":
        return next(be for be in _REGISTRY["paged_decode"]
                    if be.name == "paged_ref")
    if mode == "on" and not on_cuda:
        raise ValueError(
            "paged kernel 'on' needs a pool on a CUDA device: the port's "
            "paged_attention kernel has no interpret mode")
    return resolve("paged_decode", on_cuda=on_cuda)


# ---------------------------------------------------------------------------
# paged_prefill variant (backends registered by repro_torch.attention,
# which wires in repro_torch.attention.prefill without an import cycle)
# ---------------------------------------------------------------------------

def resolve_prefill(force: Optional[str] = None) -> Backend:
    """CUR-KV prompt attention backend: ``rank_fold`` unless ``force`` is
    "reconstruct" (the full-head-dim oracle, for tests)."""
    mode = "auto" if force is None else force
    if mode not in ("auto", "fold", "rank_fold", "reconstruct"):
        raise ValueError(
            f"prefill backend must be auto|fold|reconstruct, got {mode!r}")
    name = "reconstruct" if mode == "reconstruct" else "rank_fold"
    for be in _REGISTRY.get("paged_prefill", []):
        if be.name == name:
            return be
    raise LookupError(f"paged_prefill backend {name!r} not registered")
