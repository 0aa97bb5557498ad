"""Per-request token sampling: greedy / temperature / top-k / top-p.

Every request carries its own (temperature, top_k, top_p, seed), padded
into (B,) parameter tensors by the server. Reported logprobs always come
from the *untempered* distribution so they are comparable across requests
with different sampling settings.

Random draws come from one ``torch.Generator`` per (request, generated
token), seeded from ``(seed, rid, step)`` by :func:`request_seed`. The
stream depends only on the logical step, so it survives preemption and
is the same for single steps and multi-step windows. It is not the JAX
package's ``fold_in`` stream: the two packages agree on greedy tokens and
on the distribution they sample from, not on the sampled tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 -> greedy
    top_k: int = 0                # 0 -> disabled
    top_p: float = 1.0            # 1 -> disabled
    seed: int = 0


def request_seed(seed: int, rid: int, step: int) -> int:
    """Deterministic per-(request, generated-token) generator seed."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(rid), int(step)])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def request_generator(seed: int, rid: int, step: int,
                      device) -> torch.Generator:
    """A generator on ``device`` seeded by :func:`request_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(request_seed(seed, rid, step))
    return gen


def _filtered_logits(logits: torch.Tensor, temp, top_k, top_p
                     ) -> torch.Tensor:
    """(..., V) f32 -> temperature-scaled, top-k/top-p-filtered logits,
    the categorical's exact input. ``temp``/``top_k``/``top_p`` are
    scalars or (...,) tensors, one per row."""
    V = logits.shape[-1]
    lead = logits.shape[:-1]

    def col(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=logits.device
                               ).expand(lead)[..., None]

    temp = col(temp, torch.float32)
    top_k = col(top_k, torch.long)
    top_p = col(top_p, torch.float32)
    scaled = logits / torch.clamp(temp, min=1e-6)
    # top-k: threshold at the k-th largest scaled logit (k=0 disables)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, top_k.clamp(1, V) - 1)
    neg_inf = torch.full_like(scaled, -torch.inf)
    scaled = torch.where((top_k > 0) & (scaled < kth), neg_inf, scaled)
    # top-p (nucleus): keep the smallest prefix of the sorted distribution
    # whose *preceding* cumulative mass is < top_p (always keeps argmax)
    order = torch.argsort(-scaled, dim=-1, stable=True)
    probs = torch.gather(torch.softmax(scaled, dim=-1), -1, order)
    prev_cum = torch.cumsum(probs, dim=-1) - probs
    keep = torch.zeros_like(scaled, dtype=torch.bool).scatter(
        -1, order, prev_cum < top_p)
    return torch.where(keep, scaled, neg_inf)


def greedy_tokens(logits: torch.Tensor):
    """Argmax + its logprob, no random draws: the path when every live
    request is greedy. logits (B, V) -> (tokens (B,) int64, logprobs (B,))
    on the logits' device."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    toks = torch.argmax(logits, dim=-1)
    return toks, torch.gather(logp, -1, toks[:, None])[:, 0]


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor,
                  generators: Sequence[torch.Generator]):
    """logits (B, V); temps/top_ps (B,) f32; top_ks (B,) int; one
    generator per row (on the logits' device). Rows with temperature 0
    take the argmax. Returns (tokens (B,) int64, logprobs (B,) f32)."""
    lg = logits.float()
    logp = torch.log_softmax(lg, dim=-1)
    greedy = torch.argmax(lg, dim=-1)
    probs = torch.softmax(_filtered_logits(lg, temps, top_ks, top_ps),
                          dim=-1)
    sampled = torch.stack([
        torch.multinomial(probs[i], 1, generator=generators[i])[0]
        for i in range(lg.shape[0])])
    toks = torch.where(temps.to(lg.device) <= 0.0, greedy, sampled)
    return toks, torch.gather(logp, -1, toks[:, None])[:, 0]


def pack_params(params_list, pad_to: int, device="cpu"):
    """List of Optional[SamplingParams] -> (temps, top_ks, top_ps) tensors
    padded to ``pad_to`` rows (missing rows sample greedily)."""
    temps = np.zeros((pad_to,), np.float32)
    top_ks = np.zeros((pad_to,), np.int64)
    top_ps = np.ones((pad_to,), np.float32)
    for i, sp in enumerate(params_list[:pad_to]):
        if sp is None:
            continue
        temps[i] = sp.temperature
        top_ks[i] = sp.top_k
        top_ps[i] = sp.top_p
    return tuple(torch.from_numpy(a).to(device)
                 for a in (temps, top_ks, top_ps))
