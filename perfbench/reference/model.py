"""Plain PyTorch pieces of a llama decoder block for the benchmark's
reference (RMSNorm, rotary attention with grouped KV heads, SwiGLU MLP),
and float8 rounding for its control.

Float32, one sequence at a time, no kernels of the program, no cache and
no batching; attention is one causal ``scaled_dot_product_attention``
call. TF32 is switched off by the caller (``no_tf32``). ``fp8_round``
rounds to float8 e4m3 with absmax scales, the precision step below the
configurations' bfloat16.

Imports nothing of the program, of the JAX package or of ``jax``.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one absmax scale per slice along
    ``dim`` (returned in float32)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


def rms_norm(x, scale, eps: float):
    x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return x * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1, split-half rotation."""
    S, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, p: Dict, m: Dict) -> torch.Tensor:
    S = h.shape[0]
    H, K, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    q = rope((h @ p["wq"]).view(S, H, hd), m["rope_theta"])
    k = rope((h @ p["wk"]).view(S, K, hd), m["rope_theta"])
    v = (h @ p["wv"]).view(S, K, hd)
    G = H // K
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    q, k, v = (t.transpose(0, 1)[None] for t in (q, k, v))
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       scale=hd ** -0.5)
    o = o[0].transpose(0, 1).reshape(S, H * hd)
    return o @ p["wo"]


def mlp(h, p: Dict) -> torch.Tensor:
    g = F.silu(h @ p["w_gate"])
    return (g * (h @ p["w_up"])) @ p["w_down"]
