"""Shared low-level layers: norms, rotary embeddings, activations, and the
CUR-aware weight application used by every matmul of the model.

A "weight" in the param tree is either a plain tensor or a CUR dict made
by ``repro_torch.core.compress``:

    {"C": (m, r), "U0": (r, r), "dU": (r, r), "R": (r, n)}     # healing form
    {"CU": (m, r), "R": (r, n)}                                # folded form

``apply_w(x, w)`` dispatches on the form, so compressed and dense layers
share all model code.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# CUR-aware matmul
# ---------------------------------------------------------------------------

def is_cur(w) -> bool:
    return isinstance(w, dict) and ("C" in w or "CU" in w)


# The activation row count (flattened batch) below which a folded weight
# stays on the two-product chain: the JAX package's crossover, not yet
# re-measured on the H100.
CUR_KERNEL_MIN_M = 32


def use_cur_kernel(m: int, rk: int, n: int, M: Optional[int] = None,
                   on_cuda: bool = False) -> bool:
    """Gate for dispatching a folded CUR matmul to the fused ``cur_matmul``
    op. ``M`` is the activation row count (None: assumed large);
    ``on_cuda`` says whether the activation lies on a CUDA device. The
    shape thresholds are the JAX package's."""
    if M is not None and M < CUR_KERNEL_MIN_M:
        return False
    return (on_cuda and m >= 128 and n >= 128 and rk >= 16
            and m % 8 == 0 and n % 8 == 0)


def apply_w(x: torch.Tensor, w) -> torch.Tensor:
    """x @ W for dense or CUR-factorized W. x: (..., m) -> (..., n)."""
    if isinstance(w, dict) and "base" in w:
        raise NotImplementedError(
            "PEFT adapters (LoRA/MoRA/CURLoRA) are ported with the "
            "healing/training slice")
    if not is_cur(w):
        return x @ w
    if "CU" in w:
        cu, r = w["CU"], w["R"]
        M = math.prod(x.shape[:-1])
        if use_cur_kernel(cu.shape[0], cu.shape[1], r.shape[1], M,
                          on_cuda=x.is_cuda):
            from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
            return cur_matmul_op(x, cu.to(x.dtype), r.to(x.dtype))
        return (x @ cu) @ r
    u = (w["U0"] + w["dU"]).to(x.dtype)
    t = x @ w["C"].to(x.dtype)
    t = t @ u
    return t @ w["R"].to(x.dtype)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x, scale=None, eps: float = 1e-5):
    """f32 statistics, input-dtype data path: only the (..., 1) variance is
    f32, as in the JAX package."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = x * inv
    if scale is not None:
        y = y * scale.to(x.dtype)
    return y


def layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mu.to(x.dtype)) * inv
    if scale is not None:
        y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def norm(x, params: Optional[dict], cfg) -> torch.Tensor:
    """Config-dispatched norm. ``params`` may be None (non-parametric)."""
    scale = params.get("scale") if params else None
    if cfg.norm_type == "layernorm":
        return layer_norm(x, scale, None, cfg.norm_eps)
    return rms_norm(x, scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int. Split-half rotation."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions.float()[..., None] * inv              # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults."""
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]
