"""Paged model steps: prefill / decode over the block-table KV pool.

Mirrors ``models.model``'s forward but threads the shared paged pool.
Both entry points run over a fixed ``B = max_concurrency`` slot batch
(inactive rows are masked). Ragged prompt batches are padded up to
power-of-two buckets by the server, which keeps the flash kernel's
sequence lengths few.

Attention -- prefill AND decode -- runs in **rank space**: the key link
matrix is folded into the query (``q~ = scale * q @ Uk^T``) so scores are
taken directly against the r-dim stored keys, and the value link matrix
is applied after the softmax (``o = (p @ v_r) @ Uv``). Decode resolves
the registry's ``paged_decode`` variant (the CUDA kernel for a pool on
the card, the gather-based plain version on the CPU); CUR-KV prompt
attention resolves ``paged_prefill`` (``rank_fold`` by default).

``paged_verify`` is the speculative verify step: one forward over S
positions per slot, whose rows equal S sequential ``paged_decode`` steps.
The pools are written in place. Block tables, context lengths and masks
may be CPU tensors (the scheduler's arrays are host arrays): the write
rows are then found on the host, and a decode window syncs the device
once, when its sampled tokens are read.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.attention.prefill import (         # noqa: F401 (re-export)
    reconstructed_bytes_per_prefill)
from repro_torch.attention.registry import (        # noqa: F401 (re-export)
    fold_q, resolve_paged, resolve_prefill, unfold_o)
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import drop_lead, model_dim
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_w, norm
from repro_torch.models.model import (
    _embed, _unembed, channel_mix, head_logits, iter_layer_params,
    iter_layers, mixer_input, mixer_output, place_on_entry, serve_entry,
    take_rows, torch_dtype)
from repro_torch.serving import paged_cache as pcache
from repro_torch.serving.sampling import (
    greedy_tokens, request_generator, sample_tokens)


def _paged_attn(qg, k_pool, v_pool, table, ctx_len, uk, uv, scale,
                window: int, q_span: int = 1, paged_kernel: str = "auto"):
    """Rank-space paged attention for one layer's queries.

    qg (B, K, G, hd) grouped queries; pools (n_blocks, bs, K, r); table
    and ctx_len on the pools' device; ``paged_kernel`` as in
    ``resolve_paged``. Returns (B, K, G, hd)."""
    be = resolve_paged(k_pool.is_cuda, paged_kernel)
    qf = fold_q(qg, uk, scale)                    # (B, K, G, r)
    o_r = be.fn(qf, k_pool, v_pool, table, ctx_len, window=window,
                q_span=q_span)
    return unfold_o(o_r, uv)                      # (B, K, G, hd)


def gathered_bytes_per_step(cfg: ModelConfig, pc: pcache.PagedConfig,
                            batch: int, on_kernel: bool) -> int:
    """Device bytes the decode step materializes out of the pool per
    engine step: 0 on the kernel path (``paged_cuda``), else k+v gathers
    of the full table window for every attention layer."""
    if on_kernel:
        return 0
    L = pcache._attn_layers(cfg)
    r = pc.rank(cfg.resolved_head_dim)
    itemsize = torch.tensor([], dtype=torch_dtype(cfg.dtype)).element_size()
    return 2 * L * batch * pc.max_len * cfg.n_kv_heads * r * itemsize


def check_supported(cfg: ModelConfig) -> None:
    if not pcache.supports(cfg):
        raise ValueError(
            f"{cfg.name}: paged serving supports attention mixers only "
            "(mamba state is not paged)")


def _layer_proj(cache: dict, li: int):
    """(qk, uk, qv, uv) for layer li, or Nones when not in CUR-KV mode."""
    proj = cache.get("proj")
    if proj is None:
        return None, None, None, None
    return (proj["qk"][li], proj["uk"][li],
            proj["qv"][li], proj["uv"][li])


def _device_of(cache: dict) -> torch.device:
    return cache["k"].device


def _to(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _entry(params, cfg, pc, cache, batch: int, mesh):
    """(params, layout, rows, pool spec of one layer) of a step under
    ``mesh`` (None: the one-device path). The params are placed per
    ``param_pspecs`` (a ``Placed`` passes through), the pool must be
    placed already (``init_paged_cache(mesh=)``), and the step's slots
    split over the batch axes that divide them (``rows``), as
    ``paged_decode_pspecs`` shards every slot-batch input."""
    if mesh is None:
        return params, None, (), None
    params, lay, rows = serve_entry(params, cfg, batch, mesh)
    spec = pcache.placed_pool_spec(cache, cfg, pc, lay.mesh)
    return params, lay, rows, drop_lead(spec)


def _project(h, p, cfg, positions, lay, window):
    """(q, k, v, whether they are this rank's kv-heads) of one layer."""
    if lay is None:
        return (*attn.qkv_project(h, p, cfg, positions, window), False)
    return attn._qkv_placed(h, p, cfg, positions, lay, window)


def _out(o, heads_local, p, lay):
    """The layer's ``wo`` of attention output ``o`` (B, S, heads, hd)."""
    if lay is None:
        B, S = o.shape[:2]
        return apply_w(o.reshape(B, S, -1), p["wo"])
    return attn.out_placed(o, heads_local, p, lay)


def _pools(cache, li, pool_spec, heads_local, lay, rows, step, *ts):
    """``step(pools, *ts)`` on layer ``li``'s k / v pools. Under a mesh
    the step writes every slot's rows (``ts[-2:]``, this rank's slots,
    are all-gathered over ``rows``, since the pool is replicated over
    the batch axes) and runs on this rank's kv-heads of the pool where it
    holds them; otherwise through the pool's whole view (all-gathered
    over 'model' and its block written back: the einsum specs' rank or
    block-pool layouts) with every head. Returns ``(step's result,
    whether it ran on this rank's heads)``."""
    pools = {"k": cache["k"][li], "v": cache["v"][li]}
    if lay is None:
        return step(pools, *ts), False
    m = lay.mesh
    if rows:
        ts = ts[:-2] + tuple(col.all_gather_cat(t, 0, m, rows)
                             for t in ts[-2:])
    if heads_local and model_dim(pool_spec) == 2:
        return step(pools, *ts), True
    ts = attn.whole_heads(ts, heads_local, m)
    specs = {"k": pool_spec, "v": pool_spec}
    return attn.with_whole(pools, specs, m, lambda c: step(c, *ts)), False


def _logits(params, cfg, x, lay, rows):
    if lay is None:
        return _unembed(params, cfg, x)
    return head_logits(params, cfg, x, lay, rows)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def paged_prefill(params, cfg: ModelConfig, pc: pcache.PagedConfig,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  cache: dict, table: torch.Tensor, mesh=None,
                  backend=None):
    """Process padded ragged prompts, writing K/V into the pool in place.

    tokens (B, S) right-padded; lengths (B,) true prompt lengths (0 =
    inactive slot); table (B, maxb) block ids (-1 pad). Returns
    (last-real-token logits (B, V), cache).

    CUR-KV pools resolve the registry's ``paged_prefill`` variant
    (``backend`` pins "fold" or "reconstruct"); dense pools attend the raw
    K/V, which is the payload. ``mesh``: None, a ``DeviceMesh`` (whole
    params placed on entry) or a ``Placed``; the pool is then this rank's
    shards (``init_paged_cache(mesh=)``), each rank runs its slots on its
    shards and every rank gets the global logits."""
    check_supported(cfg)
    dev = _device_of(cache)
    B_all, S = tokens.shape
    params, lay, rows, pspec = _entry(params, cfg, pc, cache, B_all, mesh)
    m = lay.mesh if lay is not None else None
    wrows = pcache.rows_to(
        pcache.prompt_rows(table, lengths, S, pc.block_size), dev)
    tokens = _to(take_rows(tokens, rows, m).long(), dev)
    x = _embed(params, cfg, {"tokens": tokens}, lay)
    B = x.shape[0]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    scale = cfg.resolved_head_dim ** -0.5
    last = _to(torch.clamp(take_rows(lengths, rows, m).long() - 1, 0, S - 1),
               dev)
    be = resolve_prefill(backend)

    def write(pools, kc, vc):
        pcache.scatter_rows(pools["k"], kc, wrows)
        pcache.scatter_rows(pools["v"], vc, wrows)

    for li, spec, p, ll in iter_layers(params, cfg, lay):
        win = cfg.window if spec.mixer == ATTN_LOCAL else 0
        h = mixer_input(x, p, cfg)
        q, k, v, hl = _project(h, p, cfg, positions, ll, win)
        qg = attn._group_q(q, k.shape[2])
        qk, uk, qv, uv = _layer_proj(cache, li)
        if qk is None:                            # dense pool
            o = attn._mix(qg, k, v, positions, win, scale, cfg)
            kc, vc = k, v
        else:                                     # CUR-KV pool
            o, kc, vc = be.fn(qg, k, v, positions, win, scale, cfg,
                              (qk, uk, qv, uv))
        _pools(cache, li, pspec, hl, lay, rows, write, kc, vc)
        x = x + mixer_output(_out(o, hl, p, ll), p, cfg)
        x = channel_mix(x, p, spec, cfg, ll)
    x = norm(x, params.get("final_norm"), cfg)
    x_last = x[torch.arange(B, device=dev), last][:, None]
    return _logits(params, cfg, x_last, lay, rows)[:, 0, :], cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def paged_decode(params, cfg: ModelConfig, pc: pcache.PagedConfig,
                 tokens: torch.Tensor, cache: dict, table: torch.Tensor,
                 ctx_len: torch.Tensor, active: torch.Tensor, mesh=None,
                 paged_kernel: str = "auto"):
    """One decode step for every active slot, writing the pool in place:
    :func:`paged_verify` over one position.

    tokens (B, 1) last sampled token per slot; ctx_len (B,) tokens already
    in cache (the new token is written at that position); active (B,)
    bool. Returns (logits (B, V), cache). ``mesh``: as
    :func:`paged_prefill`'s."""
    logits, cache = paged_verify(params, cfg, pc, tokens, cache, table,
                                 ctx_len, active, mesh, paged_kernel)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# multi-position verify (speculative decoding)
# ---------------------------------------------------------------------------

@torch.no_grad()
def paged_verify(params, cfg: ModelConfig, pc: pcache.PagedConfig,
                 tokens: torch.Tensor, cache: dict, table: torch.Tensor,
                 ctx_len: torch.Tensor, active: torch.Tensor, mesh=None,
                 paged_kernel: str = "auto"):
    """One forward over ``S`` consecutive positions per slot -- the
    speculative verify step.

    tokens (B, S): token ``j`` is the input at position ``ctx + j`` (j = 0
    is the slot's pending next token, the rest are draft proposals); it
    may already lie on the pools' device. Per layer, all S positions' K/V
    are written to the (forked) pool first, then every query attends
    through the pool with its own causal mask ``idx <= ctx + j`` (the
    ``q_span = S`` layout of ``paged_attention``: row ``s * G + g`` of a
    kv head's ``S * G`` query rows sits at position ``ctx + s``), so row
    ``j`` equals the ``j``-th of S sequential :func:`paged_decode` calls.
    Returns (logits (B, S, V), cache); ``logits[:, j]`` is the target
    distribution of the token after position ``ctx + j``. ``paged_kernel``
    picks the attention backend (``resolve_paged``); ``mesh``: as
    :func:`paged_prefill`'s (the kernel then runs on this rank's slots
    and kv-heads)."""
    check_supported(cfg)
    dev = _device_of(cache)
    B_all, S = tokens.shape
    params, lay, rows, pspec = _entry(params, cfg, pc, cache, B_all, mesh)
    m = lay.mesh if lay is not None else None
    wrows = pcache.rows_to(pcache.span_rows(table, ctx_len, active, S,
                                            pc.block_size), dev)
    x = _embed(params, cfg,
               {"tokens": _to(take_rows(tokens, rows, m).long(), dev)}, lay)
    B = x.shape[0]
    table_d = _to(take_rows(table, rows, m).to(torch.int32), dev)
    ctx_d = _to(take_rows(ctx_len, rows, m).to(torch.int32), dev)
    pos = ctx_d[:, None] + torch.arange(S, dtype=torch.int32,
                                        device=dev)[None]
    scale = cfg.resolved_head_dim ** -0.5
    for li, spec, p, ll in iter_layers(params, cfg, lay):
        win = cfg.window if spec.mixer == ATTN_LOCAL else 0
        h = mixer_input(x, p, cfg)
        q, k, v, hl = _project(h, p, cfg, pos, ll, win)   # (B, S, ., hd)
        qk, uk, qv, uv = _layer_proj(cache, li)

        def step(pools, q, kc, vc):
            pool_k = pcache.scatter_rows(pools["k"], kc, wrows)
            pool_v = pcache.scatter_rows(pools["v"], vc, wrows)
            K = pool_k.shape[2]
            qg = attn._group_q(q, K)                      # (B, S, K, G, hd)
            G = qg.shape[3]
            qflat = qg.permute(0, 2, 1, 3, 4).reshape(B, K, S * G, -1)
            o = _paged_attn(qflat, pool_k, pool_v, table_d, ctx_d, uk, uv,
                            scale, win, q_span=S, paged_kernel=paged_kernel)
            return o.reshape(B, K, S, G, -1).permute(0, 2, 1, 3, 4)

        o, hl = _pools(cache, li, pspec, hl, lay, rows, step, q,
                       pcache.compress_kv(k, qk), pcache.compress_kv(v, qv))
        x = x + mixer_output(_out(o, hl, p, ll), p, cfg)
        x = channel_mix(x, p, spec, cfg, ll)
    x = norm(x, params.get("final_norm"), cfg)
    return _logits(params, cfg, x, lay, rows), cache      # (B, S, V)


# ---------------------------------------------------------------------------
# multi-step decode (one host sync per window)
# ---------------------------------------------------------------------------

@torch.no_grad()
def paged_decode_scan(params, cfg: ModelConfig, pc: pcache.PagedConfig,
                      tokens, cache, table, ctx, active, budgets,
                      sampling, gen_starts, n_steps: int, mesh=None,
                      greedy: bool = False, paged_kernel: str = "auto"):
    """``n_steps`` decode+sample iterations, a host loop over
    :func:`paged_decode`. Sampled tokens feed the next step on the device;
    the caller reads the window's tokens once, at its end. Rows whose
    generation budget fills mid-window freeze: their pool writes are
    masked off and the caller discards their surplus tokens.

    table/ctx/active/budgets/gen_starts (B,) host (CPU) tensors;
    ``sampling`` = (seeds, rids, temps, top_ks, top_ps), one entry per
    slot. Row ``b`` of step ``i`` draws from
    ``request_generator(seed, rid, gen_starts[b] + i)``, so windows sample
    the same stream as single steps. ``greedy`` takes the argmax path.
    ``mesh``: as :func:`paged_prefill`'s (whole params are placed once).
    Returns (tokens (n_steps, B), logprobs (n_steps, B), cache) on the
    cache's device."""
    dev = _device_of(cache)
    params, mesh = place_on_entry(params, cfg, mesh)
    toks = _to(tokens, dev)
    ctx = ctx.clone()
    out_t, out_lp = [], []
    for i in range(n_steps):
        live = active & (gen_starts + i < budgets)
        logits, cache = paged_decode(params, cfg, pc, toks, cache, table,
                                     ctx, live, mesh, paged_kernel)
        if greedy:
            s_toks, s_lps = greedy_tokens(logits)
        else:
            seeds, rids, temps, top_ks, top_ps = sampling
            gens = [request_generator(int(seeds[b]), int(rids[b]),
                                      int(gen_starts[b]) + i, dev)
                    for b in range(logits.shape[0])]
            s_toks, s_lps = sample_tokens(logits, _to(temps, dev),
                                          _to(top_ks, dev),
                                          _to(top_ps, dev), gens)
        out_t.append(s_toks)
        out_lp.append(s_lps)
        toks = s_toks[:, None]
        ctx = ctx + 1
    return torch.stack(out_t), torch.stack(out_lp), cache


# ---------------------------------------------------------------------------
# CUR-KV calibration
# ---------------------------------------------------------------------------

@torch.no_grad()
def collect_kv(params, cfg: ModelConfig, tokens: torch.Tensor
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Dense forward over a calibration batch collecting every attention
    layer's roped K/V (B, S, K, hd) -- input to the DEIM column selection."""
    check_supported(cfg)
    x = _embed(params, cfg, {"tokens": tokens})
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    scale = cfg.resolved_head_dim ** -0.5
    ks, vs = [], []
    for li, spec, p in iter_layer_params(params, cfg):
        win = cfg.window if spec.mixer == ATTN_LOCAL else 0
        h = mixer_input(x, p, cfg)
        q, k, v = attn.qkv_project(h, p, cfg, positions, win)
        ks.append(k)
        vs.append(v)
        qg = attn._group_q(q, cfg.n_kv_heads)
        o = attn._mix(qg, k, v, positions, win, scale, cfg)
        x = x + mixer_output(apply_w(o.reshape(B, S, -1), p["wo"]), p, cfg)
        x = channel_mix(x, p, spec, cfg)
    return ks, vs


def calibrate_kv(params, cfg: ModelConfig, pc: pcache.PagedConfig,
                 cache: dict, tokens: torch.Tensor) -> dict:
    """Fill ``cache['proj']`` from a calibration prompt batch."""
    if not pc.cur_kv:
        return cache
    r = pc.rank(cfg.resolved_head_dim)
    ks, vs = collect_kv(params, cfg,
                        _to(tokens.long(), _device_of(cache)))
    new = dict(cache)
    new["proj"] = pcache.projections_from_kv(ks, vs, r)
    return new
