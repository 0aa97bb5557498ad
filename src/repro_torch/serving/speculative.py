"""Speculative decoding: draft-k / verify-1 over forked paged blocks.

A copy of the JAX package's ``serving/speculative.py`` in PyTorch. Each
speculative window:

  1. **drafts** k tokens autoregressively with the cheap model (a host
     loop of k ``paged_decode`` calls), writing their K/V into *forked*
     block tables, so the parent's blocks are never touched;
  2. **verifies** all k+1 positions with ONE target forward
     (``runtime.paged_verify``: per-row math equal to k+1 sequential
     decode steps, the pool read once per (slot, layer));
  3. **accepts** a prefix and emits ``a + 1`` tokens: the ``a`` agreeing
     draft tokens plus a correction/bonus token. The scheduler commits the
     forked blocks of the accepted positions to the parent table and
     frees the rest.

Acceptance is distribution-exact:

  - greedy rows (temperature <= 0) take the token-match path: accept
    ``d_j`` iff it equals the target argmax, correct with the argmax on
    the first miss. ``paged_verify`` equals sequential ``paged_decode``,
    so the emitted stream is the non-speculative greedy stream, token for
    token.
  - sampling rows use speculative rejection sampling (Leviathan et al.
    2023; Chen et al. 2023): accept ``d_j`` with probability
    ``min(1, q(d_j) / p(d_j))`` where q / p are the *filtered* target /
    draft distributions (``sampling._filtered_logits``, the plain
    sampler's temperature/top-k/top-p), and resample the first rejection
    from the residual ``normalize(max(q - p, 0))``. The emitted marginal at
    every position is q.

Draws: every uniform comes from its own ``torch.Generator`` seeded by a
5-word ``SeedSequence`` over (seed, rid, tag, window start, in-window
index), with the three tags ``TAG_DRAFT`` / ``TAG_ACCEPT`` /
``TAG_RESAMPLE``; the plain sampler's stream is a 3-word one over (seed,
rid, step), so the streams are disjoint. They are drawn on the host, all
of a window's at its start (the resample draw for every possible accept
count), and reach the device in one copy; tokens are drawn from them by
inverse CDF. So a window syncs the device once, when its tokens are read,
and the card and the CPU draw the same uniforms. As with the port's plain
sampler, the port agrees with the JAX package on greedy tokens and on the
distribution it samples from, not on the sampled tokens (JAX draws from
``fold_in`` keys).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.models.model import place_on_entry
from repro_torch.serving import runtime
from repro_torch.serving.paged_cache import host_math
from repro_torch.serving.sampling import _filtered_logits

# the JAX package's tags: the three speculative draw streams
TAG_DRAFT = 0x5D_D1AF
TAG_ACCEPT = 0x5D_ACC9
TAG_RESAMPLE = 0x5D_4E5A


def early_exit_draft(params, cfg, n_layers: int):
    """Draft = the target's own first ``n_layers`` blocks plus its
    embedding, final norm and head: a zero-training self-draft. The draft's
    leaves are views of the target's (no copies), so it costs no parameter
    memory; only its KV pool is new. Returns ``(draft_params, draft_cfg)``
    for ``Server(draft_params=..., draft_cfg=...)``. Raises on configs of
    more than one layer group (a CURed model is unrolled into one group per
    layer)."""
    if len(cfg.groups) != 1:
        raise ValueError(
            "early_exit_draft supports single-group (uniform-stack) "
            f"configs; {cfg.name} has {len(cfg.groups)} groups")
    spec, count = cfg.groups[0]
    n = min(int(n_layers), int(count))
    if n < 1:
        raise ValueError(f"early_exit_draft needs >= 1 layer, got {n}")
    dcfg = cfg.replace(name=f"{cfg.name}-ee{n}", n_layers=n,
                       groups=((spec, n),))
    draft = dict(params)
    draft["groups"] = [[tree_map(lambda x: x[:n], blk)
                        for blk in params["groups"][0]]]
    return draft, dcfg


def draw_seed(seed: int, rid: int, tag: int, start: int, j: int) -> int:
    """Generator seed of one speculative draw."""
    ss = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(rid), int(tag), int(start), int(j)])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def window_uniforms(seeds, rids, gen_starts, active, tag: int,
                    n: int) -> torch.Tensor:
    """(B, n) f32 host tensor of U[0, 1) draws: entry (b, j) from the
    generator of (seeds[b], rids[b], tag, gen_starts[b], j); inactive rows
    hold 0.5."""
    u = torch.full((len(seeds), n), 0.5)
    for b in np.flatnonzero(np.asarray(active)):
        for j in range(n):
            gen = torch.Generator().manual_seed(draw_seed(
                seeds[b], rids[b], tag, gen_starts[b], j))
            u[b, j] = torch.rand((), generator=gen)
    return u


def _inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per row from the (unnormalised, nonnegative) weights
    ``probs`` (B, V) with uniforms ``u`` (B,): the first token whose
    cumulative weight exceeds ``u`` times the row's total. Tokens of zero
    weight are never drawn."""
    c = torch.cumsum(probs, dim=-1)
    x = (u.to(c.dtype) * c[:, -1]).unsqueeze(-1)
    idx = torch.searchsorted(c, x, right=True)[:, 0]
    return idx.clamp(max=probs.shape[-1] - 1)


def _on(sampling, dev):
    """(temps, top_ks, top_ps) of a sampling tuple on ``dev``."""
    return tuple(torch.as_tensor(t).to(dev, non_blocking=True)
                 for t in sampling[2:])


@torch.no_grad()
def draft_tokens(params, cfg, pc, tokens, cache, table, ctx, active,
                 sampling, gen_starts, k: int, mesh=None,
                 greedy: bool = False, paged_kernel: str = "auto"):
    """k autoregressive draft steps through the forked tables: a host loop
    of :func:`runtime.paged_decode`, each step's tokens feeding the next on
    the device.

    tokens (B, 1): each slot's pending next token. table / ctx / active /
    gen_starts are host arrays or tensors; ``sampling`` = (seeds, rids,
    temps, top_ks, top_ps), one entry per slot (unused under ``greedy``).
    Returns ``(d_toks (B, k), d_probs, cache)`` on the cache's device:
    ``d_probs`` (B, k, V) is the *filtered* draft distribution of each
    step (what the accept test divides by), None under ``greedy``.
    ``mesh``: as ``runtime.paged_prefill``'s, for the draft's params
    (``draft_param_pspecs``) and pool; whole params are placed once."""
    dev = cache["k"].device
    params, mesh = place_on_entry(params, cfg, mesh)
    toks = torch.as_tensor(tokens).to(dev, non_blocking=True)
    with host_math():
        ctx = torch.as_tensor(ctx).clone()
    if not greedy:
        temps, top_ks, top_ps = _on(sampling, dev)
        u = window_uniforms(sampling[0], sampling[1], gen_starts, active,
                            TAG_DRAFT, k).to(dev, non_blocking=True)
    out_t, out_p = [], []
    for j in range(k):
        logits, cache = runtime.paged_decode(params, cfg, pc, toks, cache,
                                             table, ctx, active, mesh,
                                             paged_kernel)
        lg = logits.float()
        if greedy:
            s_toks = torch.argmax(lg, dim=-1)
        else:
            probs = torch.softmax(
                _filtered_logits(lg, temps, top_ks, top_ps), dim=-1)
            s_toks = torch.where(temps <= 0.0, torch.argmax(lg, dim=-1),
                                 _inverse_cdf(probs, u[:, j]))
            out_p.append(probs)
        out_t.append(s_toks)
        toks = s_toks[:, None]
        with host_math():
            ctx = ctx + 1
    # one extra KV-only step: the loop wrote positions ctx .. ctx+k-1, but
    # a fully accepted window commits through ctx+k -- without d_k's KV
    # here the NEXT window drafts against a stale position. When the window
    # is partly accepted the write lands past the committed context (dead,
    # overwritten later).
    _, cache = runtime.paged_decode(params, cfg, pc, toks, cache, table,
                                    ctx, active, mesh, paged_kernel)
    d_probs = None if greedy else torch.stack(out_p, dim=1)
    return torch.stack(out_t, dim=1), d_probs, cache


@torch.no_grad()
def verify_tokens(params, cfg, pc, tokens, d_toks, d_probs, cache, table,
                  ctx, active, sampling, gen_starts, mesh=None,
                  greedy: bool = False, paged_kernel: str = "auto"):
    """Single-forward verification of a drafted window.

    tokens (B, k+1): ``[next_token, d_1 .. d_k]``, the verify forward's
    inputs; d_toks (B, k) the draft proposals; d_probs (B, k, V) the
    filtered draft distributions (None under ``greedy``). Returns
    ``(emitted (B, k+1), n_emit (B,), lps (B, k+1), cache)`` on the cache's
    device: row i's emitted tokens are ``emitted[i, :n_emit[i]]`` (``a``
    accepted draft tokens + 1 correction/bonus), ``lps`` their untempered
    target logprobs. ``mesh``: as ``runtime.paged_prefill``'s."""
    B, S = tokens.shape
    k = S - 1
    logits, cache = runtime.paged_verify(params, cfg, pc, tokens, cache,
                                         table, ctx, active, mesh,
                                         paged_kernel)
    lg = logits.float()                                    # (B, k+1, V)
    dev = lg.device
    logp = torch.log_softmax(lg, dim=-1)
    gr_toks = torch.argmax(lg, dim=-1)                     # (B, k+1)
    d_toks = d_toks.to(dev)
    rows = torch.arange(B, device=dev)
    acc_g = d_toks == gr_toks[:, :k]
    if greedy:
        a = torch.cumprod(acc_g.long(), dim=1).sum(dim=1)
        corr = gr_toks[rows, a]
    else:
        temps, top_ks, top_ps = _on(sampling, dev)
        p_t = torch.softmax(_filtered_logits(
            lg, temps[:, None], top_ks[:, None], top_ps[:, None]), dim=-1)
        # pad the draft distribution with a zeros row so the a == k bonus
        # draw is the same residual formula: max(q - 0, 0) = q
        p_d = torch.cat([d_probs, torch.zeros_like(d_probs[:, :1])], dim=1)
        p_t_at = torch.gather(p_t[:, :k], -1, d_toks[..., None])[..., 0]
        p_d_at = torch.gather(d_probs, -1, d_toks[..., None])[..., 0]
        seeds, rids = sampling[0], sampling[1]
        u = window_uniforms(seeds, rids, gen_starts, active, TAG_ACCEPT,
                            k).to(dev, non_blocking=True)
        # the resample draw of every possible accept count: the one of the
        # row's count is picked on the device, with no sync
        u_res = window_uniforms(seeds, rids, gen_starts, active,
                                TAG_RESAMPLE, k + 1).to(dev,
                                                        non_blocking=True)
        acc_s = u * p_d_at <= p_t_at
        acc = torch.where((temps <= 0.0)[:, None], acc_g, acc_s)
        a = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        q_a = p_t[rows, a]                                 # (B, V)
        res = torch.clamp(q_a - p_d[rows, a], min=0.0)
        # a true rejection leaves positive residual mass and a == k leaves
        # res = q; the argmax fallback only guards fp-exact q == p corners
        corr_s = torch.where((res > 0.0).any(dim=-1),
                             _inverse_cdf(res, u_res[rows, a]),
                             torch.argmax(q_a, dim=-1))
        corr = torch.where(temps <= 0.0, gr_toks[rows, a], corr_s)
    emitted = torch.cat([d_toks, torch.zeros_like(d_toks[:, :1])], dim=1)
    emitted = torch.where(
        torch.arange(S, device=dev)[None] == a[:, None], corr[:, None],
        emitted)
    lps = torch.gather(logp, -1, emitted[..., None])[..., 0]
    return emitted, a + 1, lps, cache


# ---------------------------------------------------------------------------
# host-side obs accounting
# ---------------------------------------------------------------------------

def record_window(accept_hist, window_hist, k: int, n_emit: int,
                  committed: int) -> int:
    """Per-slot window accounting on the host: observe the accepted /
    proposed ratio and the committed window size. Returns the accepted
    draft-token count."""
    accepted = int(n_emit) - 1
    accept_hist.observe(accepted / k if k else 0.0)
    window_hist.observe(committed)
    return accepted
