"""PEFT baselines the paper compares against (§5.2, §6.2): LoRA, MoRA and
CURLoRA, as weight adapters dispatched by ``layers.apply_w``.

Budget matching (paper Fig. 5-7): CURing's trainable dU has r^2 params per
target weight, so for a weight (m, n):
  LoRA rank  = max(1, r^2 // (m + n))
  MoRA size  = r (square matrix, same r^2 params)
  CURLoRA    = r columns/rows with only U (r^2) trainable.

Random draws come from one seeded ``torch.Generator``; they differ from
the JAX package's ``jax.random`` draws for the same seed.
"""
from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.bridge import flatten_up_to, tree_map


def lora_rank_for_budget(m: int, n: int, r: int) -> int:
    return max(1, (r * r) // (m + n))


def _wrap_weight(W, method: str, r: int, gen: torch.Generator):
    m, n = W.shape
    if method == "lora":
        rl = lora_rank_for_budget(m, n, r)
        A = torch.randn((m, rl), generator=gen, dtype=torch.float32,
                        device=W.device) * (1.0 / m ** 0.5)
        return {"base": W, "lora_A": A.to(W.dtype),
                "lora_B": torch.zeros((rl, n), dtype=W.dtype,
                                      device=W.device)}
    if method == "mora":
        return {"base": W, "mora": torch.zeros((r, r), dtype=torch.float32,
                                               device=W.device)}
    if method == "curlora":
        # CURLoRA (Fawi 2024): sample by INVERTED column/row norm
        # probabilities (least important features) — implicit regularization.
        Wf = W.float()
        pc = 1.0 / (torch.linalg.norm(Wf, dim=0) ** 2 + 1e-9)
        pr = 1.0 / (torch.linalg.norm(Wf, dim=1) ** 2 + 1e-9)
        q = torch.multinomial(pc / pc.sum(), min(r, n), replacement=False,
                              generator=gen)
        p = torch.multinomial(pr / pr.sum(), min(r, m), replacement=False,
                              generator=gen)
        return {"base": W, "cC": W[:, q],
                "cU": torch.zeros((p.shape[0], p.shape[0]),
                                  dtype=torch.float32, device=W.device),
                "cR": W[p, :]}
    raise ValueError(method)


def wrap_model(params, cfg, method: str, r: int, seed: int = 0,
               targets: Iterable[str] = None):
    """Attach adapters to every stacked target weight; returns a new params
    tree (the input's tensors are shared, not copied). Train with
    ``heal.trainable_mask(params, method)``."""
    targets = tuple(targets) if targets else cfg.cur_targets
    device = next(p.device for p in flatten_up_to(params, params)
                  if p is not None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    new = {k: v for k, v in params.items() if k != "groups"}
    new["groups"] = tree_map(lambda x: x, params["groups"])
    for gi, (pattern, reps) in enumerate(cfg.groups):
        for pi, spec in enumerate(pattern):
            block = new["groups"][gi][pi]
            for t in targets:
                if t not in block or not isinstance(block[t], torch.Tensor):
                    continue
                if block[t].dim() != 3:      # stacked (reps, m, n) only
                    continue
                per_rep = [_wrap_weight(W, method, r, gen)
                           for W in block[t].unbind(0)]
                block[t] = {k: block[t] if k == "base" else torch.stack(
                    [w[k] for w in per_rep]) for k in per_rep[0]}
    return new


def count_trainable(params, mask) -> int:
    return int(sum(p.numel() for p, m in zip(
        flatten_up_to(params, params), flatten_up_to(params, mask))
        if m and p is not None))
