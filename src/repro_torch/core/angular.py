"""Angular-distance layer selection (paper §4.1).

d(h_{n-1}, h_n) = arccos( <h_{n-1}, h_n> / (||h_{n-1}|| ||h_n||) ) / pi
over the hidden state of the last token, averaged over the calibration set.
Layers with the smallest distance to their predecessor are the most
redundant and are compressed first; the first and last layers are always
retained. Runs on host f32 arrays (calibration ends with one transfer).
"""
from __future__ import annotations

import numpy as np
import torch


def angular_distance(h_prev, h_next) -> float:
    """h_prev/h_next: (n_samples, D) last-token hidden states.
    Returns the mean angular distance (in [0, 1])."""
    a = torch.as_tensor(np.asarray(h_prev, np.float32))
    b = torch.as_tensor(np.asarray(h_next, np.float32))
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
    cos = torch.clamp(num / torch.clamp(den, min=1e-30), -1.0, 1.0)
    return float(torch.mean(torch.arccos(cos) / np.pi))


def layer_distances(hidden) -> np.ndarray:
    """hidden: (L+1, n_samples, D) — embedding output plus each block's
    output. Returns (L,) distances where entry n is d(h_n_in, h_n_out)."""
    L = hidden.shape[0] - 1
    return np.array([angular_distance(hidden[i], hidden[i + 1])
                     for i in range(L)])


def select_layers(distances: np.ndarray, n_compress: int,
                  method: str = "angular", seed: int = 0) -> list:
    """Pick layers to compress. First (0) and last (L-1) are excluded,
    matching the paper. ``distances[n]`` is the angular distance of block n.
    """
    L = len(distances)
    candidates = list(range(1, L - 1))
    n_compress = min(n_compress, len(candidates))
    if method == "angular":
        order = sorted(candidates, key=lambda i: distances[i])
    elif method == "last":
        order = sorted(candidates, reverse=True)
    elif method == "random":
        rng = np.random.RandomState(seed)
        order = list(rng.permutation(candidates))
    else:
        raise ValueError(method)
    return sorted(int(i) for i in order[:n_compress])
