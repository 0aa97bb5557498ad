"""Evaluation helpers: perplexity over held-out batches, and token
accuracy."""
from __future__ import annotations

import math

import torch

from repro_torch.models.model import forward, loss_fn


@torch.no_grad()
def perplexity(params, cfg, batches) -> float:
    tot, n = 0.0, 0
    for b in batches:
        tot += float(loss_fn(params, cfg, b))
        n += 1
    return math.exp(tot / max(n, 1))


@torch.no_grad()
def token_accuracy(params, cfg, batches) -> float:
    correct, total = 0, 0
    for b in batches:
        pred = torch.argmax(forward(params, cfg, b), dim=-1)
        ok = pred == b["labels"]
        mask = b.get("mask")
        if mask is not None:
            correct += int((ok * mask).sum())
            total += int(mask.sum())
        else:
            correct += int(ok.sum())
            total += ok.numel()
    return correct / max(total, 1)
