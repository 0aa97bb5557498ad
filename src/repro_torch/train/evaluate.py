"""Evaluation helpers: perplexity over held-out batches, and token
accuracy (under a ``mesh``, every rank passes the same batches; whole
params under a plain ``DeviceMesh`` are placed once)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.model import forward, loss_fn, place_on_entry


@torch.no_grad()
def perplexity(params, cfg, batches, mesh=None) -> float:
    params, mesh = place_on_entry(params, cfg, mesh)
    tot, n = 0.0, 0
    for b in batches:
        tot += float(loss_fn(params, cfg, b, mesh))
        n += 1
    return math.exp(tot / max(n, 1))


@torch.no_grad()
def token_accuracy(params, cfg, batches, mesh=None) -> float:
    params, mesh = place_on_entry(params, cfg, mesh)
    correct, total = 0, 0
    for b in batches:
        pred = torch.argmax(forward(params, cfg, b, mesh), dim=-1)
        ok = pred == b["labels"]
        mask = b.get("mask")
        if mask is not None:
            correct += int((ok * mask).sum())
            total += int(mask.sum())
        else:
            correct += int(ok.sum())
            total += ok.numel()
    return correct / max(total, 1)
