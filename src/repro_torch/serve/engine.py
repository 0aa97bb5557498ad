"""Static-batch serving engine: prefill + decode over the dense cached
model (``models.model.prefill`` / ``decode_step``), with the batching and
termination logic a server needs (static max_len, per-sequence EOS).

The JAX package jit-compiles its two step functions and caches them per
(config, mesh); the port has no jit, so ``make_prefill`` /
``make_serve_step`` return the plain closures. Under a ``mesh`` every
rank passes the same prompts and gets the same tokens: :func:`generate`
places the params once per ``param_pspecs`` and makes the cache as this
rank's shards per ``cache_pspecs``; each step runs the rank's rows of the
batch on its shards (``models.model.prefill``), and a bare step function
places whole params at every call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (
    decode_step, init_cache, place_on_entry, prefill)


def make_serve_step(cfg: ModelConfig, mesh=None):
    """Decode step: (params, cache, batch {tokens (B,1)}, pos (B,1)) ->
    (logits (B,V), cache)."""

    def serve_step(params, cache, batch, pos):
        return decode_step(params, cfg, batch, cache, pos, mesh)

    return serve_step


def make_prefill(cfg: ModelConfig, mesh=None):
    def prefill_fn(params, cache, batch):
        return prefill(params, cfg, batch, cache, mesh)

    return prefill_fn


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor        # (B, n_new) int64
    logprobs: torch.Tensor      # (B, n_new), the logits' dtype


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompts: torch.Tensor, n_new: int,
             *, temperature: float = 0.0, seed: int = 0, mesh=None,
             eos_id: Optional[int] = None) -> GenerationResult:
    """Greedy/temperature sampling for a batch of same-length prompts.

    ``prompts`` (B, S) int tokens on the params' device; the cache, the
    sampling generator and the result live there too. Greedy tokens and
    logprobs equal the JAX package's. Temperature sampling draws from one
    ``torch.Generator`` seeded with ``seed`` on that device: it agrees
    with JAX's ``jax.random.categorical`` in distribution, not in the
    sampled tokens. With ``eos_id``, finished rows emit ``eos_id`` with
    logprob 0, and the loop stops once every row is done (one host sync
    per step, as the JAX engine's ``bool(done.all())``)."""
    prompts = prompts.long()
    dev = prompts.device
    B, S = prompts.shape
    params, mesh = place_on_entry(params, cfg, mesh)
    cache = init_cache(cfg, B, S + n_new, dev, mesh=mesh)
    pf, st = make_prefill(cfg, mesh), make_serve_step(cfg, mesh)
    logits, cache = pf(params, cache, {"tokens": prompts})
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    toks, lps = [], []
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(n_new):
        if gen is not None:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        lp = torch.log_softmax(logits, dim=-1)
        lp_nxt = torch.gather(lp, -1, nxt[:, None])[:, 0]
        # freeze finished sequences: emit eos with logprob 0 instead of
        # sampling on (their cache writes are position-idempotent)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            lp_nxt = torch.where(done, torch.zeros_like(lp_nxt), lp_nxt)
        toks.append(nxt)
        lps.append(lp_nxt)
        if eos_id is not None:
            done = done | (nxt == eos_id)
            if bool(done.all()):
                break           # all retired: stop burning decode steps
        if t + 1 < n_new:
            pos = torch.full((B, 1), S + t, dtype=torch.int32, device=dev)
            logits, cache = st(params, cache, {"tokens": nxt[:, None]}, pos)
    return GenerationResult(tokens=torch.stack(toks, dim=1),
                            logprobs=torch.stack(lps, dim=1))
