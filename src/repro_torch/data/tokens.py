"""Synthetic C4-like token stream: deterministic and resumable.

The "corpus" is a seeded Zipf-distributed Markov token stream, as in the
JAX package: skewed unigrams and bigram dependencies. The tables come from
the same numpy draws as the JAX package's, but tokens are sampled with a
``torch.Generator`` on the device, so the stream differs from JAX's; tests
that compare the two packages feed both the same numpy batches.

``batch_at(step)`` is a pure function of (seed, step).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_states: int = 64


class SyntheticLM:
    """Markov-modulated Zipf token stream."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.RandomState(cfg.seed)
        V, M = cfg.vocab_size, cfg.markov_states
        ranks = np.arange(1, V + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        probs /= probs.sum()
        self._base_logp = torch.tensor(np.log(probs), dtype=torch.float32,
                                       device=self.device)
        self._perms = torch.tensor(
            np.stack([rng.permutation(V) for _ in range(M)]),
            dtype=torch.long, device=self.device)
        self._trans = torch.tensor(rng.randint(1, M, size=(M,)),
                                   dtype=torch.long, device=self.device)

    @torch.no_grad()
    def batch_at(self, step: int) -> dict:
        """Global batch for ``step``: tokens/labels (B, S) int64."""
        cfg = self.cfg
        B, S, M = cfg.global_batch, cfg.seq_len, cfg.markov_states
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed * 1_000_003 + step)
        state = torch.randint(0, M, (B,), generator=gen, device=self.device)
        toks = []
        for _ in range(S + 1):
            logits = self._base_logp[self._perms[state]]          # (B, V)
            u = torch.rand(logits.shape, generator=gen, device=self.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            tok = torch.argmax(logits + gumbel, dim=-1)
            state = (state * 31 + tok + self._trans[state]) % M
            toks.append(tok)
        toks = torch.stack(toks, dim=1)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}

