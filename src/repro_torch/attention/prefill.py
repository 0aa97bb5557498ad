"""Rank-space prefill backends for CUR-KV paged pools.

``rank_fold`` (the default):
    q~ = scale * q @ Uk^T                 (B, S, K, G, r)
    k_c = k[..., qk], v_c = v[..., qv]    (B, S, K, r)  -- the DEIM columns
    o  = softmax(q~ k_c^T) v_c @ Uv

  Attention runs at feature dim r with ``scale=1.0`` (the scale is folded
  into q~) through whatever ``mix`` backend the registry resolves (the
  CUDA flash kernel pads r up to its next width), and the same
  ``(B, S, K, r)`` compressed arrays are written to the pool: one pass,
  no full-head-dim K/V bytes, and every prompt position attends the exact
  compressed K/V that decode will read.

``reconstruct`` (the oracle):
    k^ = k_c @ Uk, v^ = v_c @ Uv, then ordinary full-head-dim attention.

  Algebraically the same as ``rank_fold``; kept for tests.

Both return ``(o, k_c, v_c)`` so the runtime writes the compressed blocks
without re-deriving them.
"""
from __future__ import annotations

import torch

from repro_torch.attention import registry
from repro_torch.attention.registry import fold_q, unfold_o


def _compress(x, idx):
    """(..., hd) -> (..., r): keep the DEIM-selected feature columns."""
    return torch.index_select(x, -1, idx.long())


def fold_prefill(qg, k, v, positions, window: int, scale: float, cfg,
                 proj):
    """Rank-space prompt attention. qg (B,S,K,G,hd); k,v (B,S,K,hd);
    proj = (qk, uk, qv, uv). Returns (o (B,S,K,G,hd), k_c, v_c)."""
    qk, uk, qv, uv = proj
    kc = _compress(k, qk)
    vc = _compress(v, qv)
    qf = fold_q(qg, uk, scale)
    o_r = registry.mix(qf, kc, vc, positions, window, 1.0, cfg)
    return unfold_o(o_r, uv), kc, vc


def reconstruct_prefill(qg, k, v, positions, window: int, scale: float,
                        cfg, proj):
    """Reconstruct-then-attend oracle: same math as :func:`fold_prefill`
    with the link matrices applied to K/V instead of q/o."""
    qk, uk, qv, uv = proj
    kc = _compress(k, qk)
    vc = _compress(v, qv)
    kh = (kc.float() @ uk.float()).to(k.dtype)
    vh = (vc.float() @ uv.float()).to(v.dtype)
    o = registry.mix(qg, kh, vh, positions, window, scale, cfg)
    return o, kc, vc


def reconstructed_bytes_per_prefill(cfg, pc, batch: int, bucket: int,
                                    backend: str = "rank_fold") -> int:
    """Full-head-dim K/V bytes a CUR-KV prefill materializes per
    bucket-padded prompt batch: 0 on the fold path and for dense pools."""
    if not pc.cur_kv or backend in ("rank_fold", "fold", "auto"):
        return 0
    from repro_torch.models.model import torch_dtype
    from repro_torch.serving.paged_cache import _attn_layers
    L = _attn_layers(cfg)
    itemsize = torch.tensor([], dtype=torch_dtype(cfg.dtype)).element_size()
    return (2 * L * batch * bucket * cfg.n_kv_heads
            * cfg.resolved_head_dim * itemsize)
