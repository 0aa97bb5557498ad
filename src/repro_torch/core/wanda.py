"""WANDA importance (Sun et al. 2023): fuse weight magnitudes with input
activation norms. Weights follow the y = x @ W convention (W: in x out), so
activations scale ROWS: S_ij = |W_ij| * a_i with a_i = ||X_i||_2 over all
calibration tokens.
"""
from __future__ import annotations

import torch


def wanda_scores(W: torch.Tensor, act_sq: torch.Tensor) -> torch.Tensor:
    """W (..., m, n); act_sq (..., m) accumulated sum of squared activations
    per input feature. Returns the importance matrix S (..., m, n) in f32."""
    a = torch.sqrt(torch.clamp(act_sq.float(), min=0.0))
    return torch.abs(W.float()) * a[..., :, None]
