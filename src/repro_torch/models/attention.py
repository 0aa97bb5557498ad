"""GQA attention with RoPE: projections and full-sequence attention.

The attention math lives in the backend registry
(``repro_torch.attention``): :func:`_mix` resolves the ``mix`` variant —
the CUDA flash kernel for CUDA tensors, else the small-S dense oracle, else
the chunked/banded plain paths. ``DENSE_MAX`` and ``CHUNK`` stay module
globals here, as in the JAX package, and ``_mix`` threads the live values
through the registry on every call. Prefill and decode with caches wait for
the serving slice.
"""
from __future__ import annotations

from repro_torch.attention import registry as attn_registry
from repro_torch.attention import xla as attn_xla
from repro_torch.models.layers import apply_rope, apply_w, rms_norm

DENSE_MAX = attn_xla.DENSE_MAX   # dense softmax at/below this seq length
CHUNK = attn_xla.CHUNK           # flash chunk (query and kv)


def qkv_project(x, p, cfg, positions):
    """x (B,S,D) -> q (B,S,H,hd), k,v (B,S,K,hd), roped."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = apply_w(x, p["wq"]).reshape(B, S, H, hd)
    k = apply_w(x, p["wk"]).reshape(B, S, K, hd)
    v = apply_w(x, p["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _group_q(q, n_kv):
    """(B,S,H,hd) -> (B,S,K,G,hd) grouped for GQA."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def _mix(qg, k, v, positions, window, scale, cfg=None):
    """Registry-resolved full-sequence attention (see module docstring)."""
    return attn_registry.mix(qg, k, v, positions, window, scale, cfg,
                             dense_max=DENSE_MAX)


def attn_forward(x, p, cfg, positions, *, window: int = 0):
    """Full-sequence attention. x (B,S,D) -> (B,S,D)."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = hd ** -0.5
    q, k, v = qkv_project(x, p, cfg, positions)
    qg = _group_q(q, K)
    o = _mix(qg, k, v, positions, window, scale, cfg)
    o = o.reshape(B, S, H * hd)
    return apply_w(o, p["wo"])
