"""Weights made on the device from the seed, in the program's parameter
layout and in the dtype they are served in, a few large draws a leaf.

The layout comes from the program's own ``init_params`` on the ``meta``
device (shapes only, nothing drawn). Each stacked leaf (all layers of a
weight) is one ``torch.randn`` on a generator on the card, scaled by the
fan-in. Each CUR target (``wq``, ``wk``, ``w_gate`` of a dense MLP) has
a decaying spectrum of full rank: A diag(s) B with A (m, k) and B (k, n)
Gaussian, k = min(m, n) and s_i = 1 / (1 + i / ``target_decay``), scaled
to the same entry variance as the other weights. Its rank is well above
any r_max, so the rows and columns CUR picks change C' R. Norm scales
are ones; the router is f32.
"""
from __future__ import annotations

import math

import torch

# layers drawn together for a CUR target (bounds the factors' memory)
CHUNK = 4


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def decaying(shape, decay: float, std: float, gen, dtype, device):
    """(L, m, n): each layer A diag(s) B as the module docstring says,
    with entries of standard deviation ``std``."""
    L, m, n = shape
    k = min(m, n)
    s = 1.0 / (1.0 + torch.arange(k, dtype=torch.float32,
                                  device=device) / decay)
    s = (s * (std / float(s.square().sum().sqrt()))).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for l0 in range(0, L, CHUNK):
        l1 = min(L, l0 + CHUNK)
        left = torch.randn((l1 - l0, m, k), generator=gen, dtype=dtype,
                           device=device).mul_(s)
        right = torch.randn((l1 - l0, k, n), generator=gen, dtype=dtype,
                            device=device)
        torch.bmm(left, right, out=out[l0:l1])
        del left, right
    return out


def make_params(cfg, spec: dict, seed: int, device) -> dict:
    from repro_torch.models.model import init_params
    meta = init_params(0, cfg, device="meta")
    gen = _generator(seed, device)
    targets = set(spec["targets"])
    decay = float(spec["target_decay"])

    def fill(path, a):
        name = path[-1]
        if name == "scale":
            return torch.ones(a.shape, dtype=a.dtype, device=device)
        if name == "embed":
            w = torch.randn(a.shape, generator=gen, dtype=a.dtype,
                            device=device)
            return w.mul_(0.02)
        std = 1.0 / math.sqrt(a.shape[-2])
        if name in targets and a.dim() == 3:
            return decaying(tuple(a.shape), decay, std, gen, a.dtype,
                            device)
        w = torch.randn(a.shape, generator=gen, dtype=a.dtype, device=device)
        return w.mul_(std)

    return _map_with_path(fill, meta, ())


def _map_with_path(fn, tree, path):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)
