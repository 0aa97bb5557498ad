"""GQA attention with RoPE: projections, full-sequence attention, and the
dense KV cache (prefill fill and single-token decode).

The full-sequence attention math lives in the backend registry
(``repro_torch.attention``): :func:`_mix` resolves the ``mix`` variant —
the CUDA flash kernel for CUDA tensors, else the small-S dense oracle, else
the chunked/banded plain paths. ``DENSE_MAX`` and ``CHUNK`` stay module
globals here, as in the JAX package, and ``_mix`` threads the live values
through the registry on every call.

Under a placed mesh (:func:`attn_forward`'s ``mesh``, a
``repro_torch.dist.sharding.Placed`` of the layer) the projections run
their Megatron layouts through ``apply_w``. When the column shards hold
whole heads (H and K divide over 'model') attention runs on this rank's
heads: Q heads in contiguous blocks, so each GQA group stays on one rank.
Otherwise (a shard that cuts through a head: gemma3's one kv head of 256
divides over 4 by width, not by heads) the projections are all-gathered
over 'model', attention runs whole on every rank, and this rank's block
of its output feeds the row-parallel ``wo``. Both give JAX's values.

Decode (:func:`attn_decode`): one query token against a dense per-layer
KV cache, in plain tensor ops (it runs outside any Pallas kernel in the
JAX package too); local layers keep a ring buffer of ``window`` slots.
Cache writes are in place; the functions still return the cache, so the
signatures stay the JAX package's. (The paged serving runtime has its own
pool-backed decode path: ``repro_torch.serving.runtime``.)
"""
from __future__ import annotations

import torch

from repro_torch.attention import registry as attn_registry
from repro_torch.attention import xla as attn_xla
from repro_torch.attention.xla import NEG_INF
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import model_dim
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import (
    apply_rope, apply_w, out_local, rms_norm, to_input)

DENSE_MAX = attn_xla.DENSE_MAX   # dense softmax at/below this seq length
CHUNK = attn_xla.CHUNK           # flash chunk (query and kv)


def roped(cfg, window: int) -> bool:
    """Whether a layer of this ``window`` (0: full attention) rotates q
    and k: always, unless ``cfg.rope_on_global`` is off and the layer is
    a full one (NoPE)."""
    return bool(window) or cfg.rope_on_global


def qkv_project(x, p, cfg, positions, window: int = 0):
    """x (B,S,D) -> q (B,S,H,hd), k,v (B,S,K,hd), roped (see
    :func:`roped`) after the optional per-head q / k norm."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = apply_w(x, p["wq"]).reshape(B, S, H, hd)
    k = apply_w(x, p["wk"]).reshape(B, S, K, hd)
    v = apply_w(x, p["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if roped(cfg, window):
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


def attn_forward(x, p, cfg, positions, *, window: int = 0, mesh=None):
    """Full-sequence attention. x (B,S,D) -> (B,S,D). ``mesh``: a
    ``Placed`` of this layer's params (see the module docstring)."""
    if mesh is not None:
        return _attn_placed(x, p, cfg, positions, window, mesh)
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = hd ** -0.5
    q, k, v = qkv_project(x, p, cfg, positions, window)
    qg = _group_q(q, K)
    o = _mix(qg, k, v, positions, window, scale, cfg)
    o = o.reshape(B, S, H * hd)
    return apply_w(o, p["wo"])


def _qkv_placed(x, p, cfg, positions, lay, window: int = 0):
    """Roped q (B,S,Hl,hd), k, v (B,S,Kl,hd) from a rank's shards, and
    whether they are this rank's heads (else the whole heads: the gather
    fallback when a column shard cuts through a head)."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mesh = lay.mesh
    n = axis_sizes(mesh)["model"]
    names = ("wq", "wk", "wv")
    ys = [apply_w(x, p[w], lay.spec(w), mesh) for w in names]
    local = [out_local(lay.spec(w)) for w in names]
    if all(local) and H % n == 0 and K % n == 0:
        Hl, Kl, heads_local = H // n, K // n, True
    else:
        ys = [col.gather(y, -1, mesh, "model") if loc else y
              for y, loc in zip(ys, local)]
        Hl, Kl, heads_local = H, K, False
    q = ys[0].reshape(B, S, Hl, hd)
    k = ys[1].reshape(B, S, Kl, hd)
    v = ys[2].reshape(B, S, Kl, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if roped(cfg, window):
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, heads_local


def out_placed(o, heads_local, p, lay):
    """The row-parallel ``wo`` of attention output ``o`` (B, S, heads,
    hd): this rank's heads, or the whole heads (the rank's block feeds
    ``wo``)."""
    B, S = o.shape[:2]
    o = to_input(o.reshape(B, S, -1), heads_local, lay.spec("wo"), lay.mesh)
    return apply_w(o, p["wo"], lay.spec("wo"), lay.mesh)


def whole_heads(ts, heads_local, mesh):
    """(q, k, v) with every head: all-gathered over 'model' along the
    heads dim when they are this rank's."""
    if not heads_local:
        return ts
    return tuple(col.all_gather_cat(t, 2, mesh, "model") for t in ts)


def _attn_placed(x, p, cfg, positions, window, lay):
    """attn_forward on a rank's shards: local heads, or the gather
    fallback when a column shard cuts through a head."""
    q, k, v, heads_local = _qkv_placed(x, p, cfg, positions, lay, window)
    hd = cfg.resolved_head_dim
    o = _mix(_group_q(q, k.shape[2]), k, v, positions, window, hd ** -0.5,
             cfg)
    return out_placed(o, heads_local, p, lay)


def with_whole(cache, specs, mesh, fn):
    """``fn(view)`` on the whole (over 'model') view of a cache dict whose
    leaves are a rank's shards per ``specs``: each leaf sharded over
    'model' is all-gathered for the view and its block written back after
    ``fn`` (which writes the view in place). Returns ``fn``'s result."""
    view = {name: col.relayout(t, model_dim(specs.get(name)), None, mesh)
            for name, t in cache.items()}
    out = fn(view)
    for name, t in cache.items():
        d = model_dim(specs.get(name))
        if d is not None:
            t.copy_(col.block(view[name], d, mesh, "model"))
    return out


def _cache_heads(spec) -> bool:
    """Whether a (B, L, K, hd) cache leaf's spec holds this rank's
    kv-heads."""
    return model_dim(spec) == 2


def attn_prefill(x, p, cfg, positions, cache, *, window: int = 0,
                 mesh=None, cache_spec=None):
    """Forward + KV-cache fill. Returns (out, cache). ``mesh``: a
    ``Placed`` of this layer's params; ``cache`` is then this rank's
    shards of the layer's cache per ``cache_spec`` (its kv-heads, or
    where they do not divide over 'model' a block of head_dim or of the
    cache length, which the fill writes through the whole view)."""
    if mesh is not None:
        q, k, v, hl = _qkv_placed(x, p, cfg, positions, mesh, window)
        hd = cfg.resolved_head_dim
        o = _mix(_group_q(q, k.shape[2]), k, v, positions, window,
                 hd ** -0.5, cfg)
        if hl and _cache_heads(cache_spec["k"]):
            attn_fill_cache(cache, k, v, positions, window)
        else:
            kw, vw = whole_heads((k, v), hl, mesh.mesh)
            with_whole(cache, cache_spec, mesh.mesh, lambda c: attn_fill_cache(
                c, kw, vw, positions, window))
        return out_placed(o, hl, p, mesh), cache
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = hd ** -0.5
    q, k, v = qkv_project(x, p, cfg, positions, window)
    qg = _group_q(q, K)
    o = _mix(qg, k, v, positions, window, scale, cfg)
    o = o.reshape(B, S, H * hd)
    cache = attn_fill_cache(cache, k, v, positions, window)
    return apply_w(o, p["wo"]), cache


def init_attn_cache(cfg, batch: int, max_len: int, window: int, dtype,
                    device):
    """KV cache for one attention layer on ``device``. Local layers: a ring
    buffer of min(max_len, window) slots."""
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    L = min(max_len, window) if window > 0 else max_len
    return {
        "k": torch.zeros((batch, L, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, K, hd), dtype=dtype, device=device),
        # absolute position of each slot (-1 = empty)
        "pos": torch.full((batch, L), -1, dtype=torch.int32, device=device),
    }


def attn_fill_cache(cache, k, v, positions, window: int):
    """Write a full prefill's K/V into the cache in place (the last ``L``
    tokens, at slot ``pos % L``, for local ring buffers)."""
    L = cache["k"].shape[1]
    S = k.shape[1]
    if S <= L:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["pos"][:, :S] = positions
        return cache
    kt, vt, pt = k[:, -L:], v[:, -L:], positions[:, -L:]
    slots = (pt % L).long()                            # (B, L)
    b_idx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][b_idx, slots] = kt
    cache["v"][b_idx, slots] = vt
    cache["pos"][b_idx, slots] = pt.to(torch.int32)
    return cache


def _decode_attend(q, k, v, cache, pos, window: int):
    """Write the token's k, v (B,1,K,hd) at slot ``pos`` (``pos % L`` for
    a ring buffer) in place, then attend q (B,1,H,hd) over the cache.
    Returns o (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    scale = hd ** -0.5
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    L = ck.shape[1]
    slot = ((pos[:, 0] % L) if window > 0 else pos[:, 0]).long()
    b_idx = torch.arange(B, device=q.device)
    ck[b_idx, slot] = k[:, 0]
    cv[b_idx, slot] = v[:, 0]
    cp[b_idx, slot] = pos[:, 0].to(torch.int32)
    qg = _group_q(q, K)                                # (B,1,K,G,hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, ck).float() * scale
    valid = (cp >= 0) & (cp <= pos[:, :1])
    if window > 0:
        valid &= cp > (pos[:, :1] - window)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", pr.to(cv.dtype), cv)
    return o.reshape(B, 1, H, hd)


def attn_decode(x, p, cfg, cache, pos, *, window: int = 0, mesh=None,
                cache_spec=None):
    """Single-token decode. x (B,1,D); pos (B,1) absolute positions. Writes
    slot ``pos`` (``pos % L`` for a ring buffer) in place, then attends over
    the cache: scores in the cache dtype, cast to f32 and scaled, masked to
    the filled slots at or before ``pos`` (and inside the window), softmax,
    probabilities cast back to the cache dtype for PV. Returns (out,
    cache). ``mesh`` / ``cache_spec``: as :func:`attn_prefill`'s (a cache
    not sharded by kv-heads is attended through its whole view)."""
    if mesh is not None:
        q, k, v, hl = _qkv_placed(x, p, cfg, pos, mesh, window)
        if hl and _cache_heads(cache_spec["k"]):
            o = _decode_attend(q, k, v, cache, pos, window)
        else:
            q, k, v = whole_heads((q, k, v), hl, mesh.mesh)
            hl = False
            o = with_whole(cache, cache_spec, mesh.mesh,
                           lambda c: _decode_attend(q, k, v, c, pos, window))
        return out_placed(o, hl, p, mesh), cache
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = qkv_project(x, p, cfg, pos, window)      # (B,1,.,hd)
    o = _decode_attend(q, k, v, cache, pos, window)
    return apply_w(o.reshape(B, 1, H * hd), p["wo"]), cache
