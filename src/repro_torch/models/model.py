"""Model assembly: init / forward / loss over layer groups.

A model's layers are organized as ``cfg.groups = [(pattern, repeats), ...]``.
Parameters for a group are a list of per-pattern-position param dicts whose
leaves carry a leading ``repeats`` axis (the JAX package's layout, so the
bridge maps one tree onto the other). The JAX ``lax.scan`` over repeats is
a Python loop over views here.

This slice ports the attention (ATTN / ATTN_LOCAL) + MLP families; MoE and
Mamba blocks raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.bridge import tree_map
from repro_torch.configs.base import (
    ATTN, ATTN_LOCAL, MAMBA, MLP, MOE, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models.layers import norm
from repro_torch.models.mlp import mlp_forward

Params = Dict[str, Any]

_LATER = {MAMBA: "the other-families slice (models/mamba.py)",
          MOE: "the other-families slice (models/moe.py)"}


def _not_ported(kind: str):
    return NotImplementedError(
        f"{kind} blocks are not ported yet; they come with {_LATER[kind]}")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(gen, reps: int, m: int, n: int, dtype, device):
    """(reps, m, n) scaled truncated-normal (fan-in) weights, each drawn in
    f32 and cast, one repeat at a time (no full-size f32 temporary)."""
    out = torch.empty((reps, m, n), dtype=dtype, device=device)
    std = 1.0 / math.sqrt(m)
    tmp = torch.empty((m, n), dtype=torch.float32, device=device)
    for i in range(reps):
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0, generator=gen)
        out[i] = tmp * std
    return out


def embed_init(gen, v: int, d: int, dtype, device):
    w = torch.randn((v, d), generator=gen, dtype=torch.float32,
                    device=device) * 0.02
    return w.to(dtype)


def init_block(gen, spec, cfg: ModelConfig, reps: int, device) -> Params:
    """Stacked params of ``reps`` blocks of one pattern position."""
    D = cfg.d_model
    dtype = torch_dtype(cfg.dtype)
    p: Params = {}

    def ones(n):
        return torch.ones((reps, n), dtype=dtype, device=device)

    if cfg.parametric_norm:
        p["norm1"] = {"scale": ones(D)}
    if spec.mixer in (ATTN, ATTN_LOCAL):
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        p["wq"] = dense_init(gen, reps, D, H * hd, dtype, device)
        p["wk"] = dense_init(gen, reps, D, K * hd, dtype, device)
        p["wv"] = dense_init(gen, reps, D, K * hd, dtype, device)
        p["wo"] = dense_init(gen, reps, H * hd, D, dtype, device)
        if cfg.qk_norm:
            p["q_norm"] = ones(hd)
            p["k_norm"] = ones(hd)
    else:
        raise _not_ported(spec.mixer)
    if spec.mlp == MLP:
        if cfg.parametric_norm:
            p["norm2"] = {"scale": ones(D)}
        F = cfg.d_ff
        if cfg.gated_mlp:
            p["w_gate"] = dense_init(gen, reps, D, F, dtype, device)
        p["w_up"] = dense_init(gen, reps, D, F, dtype, device)
        p["w_down"] = dense_init(gen, reps, F, D, dtype, device)
    else:
        raise _not_ported(spec.mlp)
    return p


def init_params(seed: int, cfg: ModelConfig, device=None) -> Params:
    """Random params made on ``device`` from one ``torch.Generator`` seeded
    with ``seed``. The stream differs from ``jax.random``'s: tests that
    compare with the JAX package bridge JAX's params instead."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    params: Params = {"groups": []}
    if cfg.input_mode == "tokens":
        params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                     dtype, device)
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        params["out_head"] = dense_init(gen, 1, cfg.d_model, cfg.vocab_size,
                                        dtype, device)[0]
    if cfg.parametric_norm:
        params["final_norm"] = {"scale": torch.ones(
            (cfg.d_model,), dtype=dtype, device=device)}
    for pattern, reps in cfg.groups:
        params["groups"].append(
            [init_block(gen, spec, cfg, reps, device) for spec in pattern])
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def block_forward(x, p, spec, cfg, positions):
    h = norm(x, p.get("norm1"), cfg)
    if spec.mixer in (ATTN, ATTN_LOCAL):
        win = cfg.window if spec.mixer == ATTN_LOCAL else 0
        a = attn.attn_forward(h, p, cfg, positions, window=win)
    else:
        raise _not_ported(spec.mixer)
    x = x + a
    if spec.mlp == MLP:
        h = norm(x, p.get("norm2"), cfg)
        x = x + mlp_forward(h, p, cfg)
    else:
        raise _not_ported(spec.mlp)
    return x


def _embed(params, cfg, batch):
    if cfg.input_mode == "tokens":
        x = params["embed"][batch["tokens"]]
    else:
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _unembed(params, cfg, x):
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        return x @ params["embed"].T
    return x @ params["out_head"]


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None].expand(B, S)


def iter_layer_params(params, cfg):
    """Yield (layer_idx, spec, per-layer param dict) in network order; the
    per-layer leaves are views into the stacked ones."""
    li = 0
    for gi, (pattern, reps) in enumerate(cfg.groups):
        gp = params["groups"][gi]
        for r in range(reps):
            for pi, spec in enumerate(pattern):
                yield li, spec, tree_map(lambda a, r=r: a[r], gp[pi])
                li += 1


def apply_groups(x, params, cfg, positions):
    """Run all layer groups over x."""
    for _, spec, lp in iter_layer_params(params, cfg):
        x = block_forward(x, lp, spec, cfg, positions)
    return x


@torch.no_grad()
def forward(params, cfg: ModelConfig, batch):
    """Full-sequence forward -> logits (B, S, V)."""
    x = _embed(params, cfg, batch)
    positions = _positions(x)
    x = apply_groups(x, params, cfg, positions)
    x = norm(x, params.get("final_norm"), cfg)
    return _unembed(params, cfg, x)


@torch.no_grad()
def forward_hidden(params, cfg: ModelConfig, batch):
    """Forward that also returns every block's output hidden state.
    Returns (logits, hidden) with hidden (L+1, B, S, D): the embedding
    output followed by each block's output."""
    x = _embed(params, cfg, batch)
    positions = _positions(x)
    collected = [x]
    for _, spec, lp in iter_layer_params(params, cfg):
        x = block_forward(x, lp, spec, cfg, positions)
        collected.append(x)
    hidden = torch.stack(collected)
    x = norm(x, params.get("final_norm"), cfg)
    return _unembed(params, cfg, x), hidden


@torch.no_grad()
def loss_fn(params, cfg, batch):
    """Mean next-token cross-entropy (masked mean when ``batch`` has a
    ``mask``)."""
    logits = forward(params, cfg, batch).float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ll = gold - lse
    mask = batch.get("mask")
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
