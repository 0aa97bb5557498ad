"""Mixture-of-Experts channel mixer (``repro.models.moe`` on one device).

The JAX package dispatches on ``cfg.moe_impl`` and the mesh: with no mesh
it always runs ``moe_dense``, whatever ``moe_impl`` says. The port has no
mesh, so :func:`moe_forward` is :func:`moe_dense`: every expert applied to
every token, the top-k outputs gathered and weighted by the renormalized
gates. That costs E / k times the routed FLOPs (the JAX oracle's cost).
The expert-parallel and expert-TP bodies run only under ``shard_map``;
they come with the distributed slice.

Routing: softmax-then-top-k with renormalized gates (Mixtral convention).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import act_fn
from repro_torch.models.mlp import mlp_forward


def route(xt, router, k: int):
    """xt (T, D) -> (gates (T, k) f32, experts (T, k) int64).

    The logits are taken in x's dtype and softmaxed in f32, as in JAX.
    The top k come from a stable descending sort, so that equal
    probabilities pick the lower expert index first, as ``jax.lax.top_k``
    does (``torch.topk`` promises no order among ties)."""
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi


# (E, T, F) elements of one token chunk's expert activations: long
# prompts run in chunks of tokens so the temporaries stay bounded (512 MB
# a tensor in bf16); a token's result does not depend on its chunk but
# for the summation order a GEMM picks by its row count
CHUNK_ELEMS = 1 << 28


def _experts(xt, experts, gates, p, act):
    """The routed output of tokens xt (T, D): every expert applied, the
    top-k gathered and weighted. The products keep the expert axis
    leading, (E, T, .), so no operand is permuted."""
    g = act(torch.matmul(xt, p["w_gate"]))                  # (E, T, F)
    u = torch.matmul(xt, p["w_up"])
    y = torch.matmul(g * u, p["w_down"])                    # (E, T, D)
    tok = torch.arange(xt.shape[0], device=xt.device)[:, None]
    sel = y[experts, tok]                                   # (T, k, D)
    return (sel * gates[:, :, None].to(sel.dtype)).sum(dim=1)


def moe_dense(x, p, cfg):
    """x (B, S, D) -> (B, S, D): all experts on all tokens, the routed ones
    gathered and weighted, plus the shared expert's MLP."""
    B, S, D = x.shape
    T = B * S
    act = act_fn(cfg.mlp_act)
    xt = x.reshape(T, D)
    gates, experts = route(xt, p["router"], cfg.n_experts_per_tok)
    E, _, F = p["w_gate"].shape
    step = max(1, CHUNK_ELEMS // (E * F))
    out = torch.cat([_experts(xt[t:t + step], experts[t:t + step],
                              gates[t:t + step], p, act)
                     for t in range(0, T, step)])
    if cfg.n_shared_experts:
        out = out + mlp_forward(xt, p["shared"], cfg)
    return out.reshape(B, S, D)


def moe_forward(x, p, cfg):
    """x (B, S, D) -> (B, S, D). One device: the dense path."""
    return moe_dense(x, p, cfg)
