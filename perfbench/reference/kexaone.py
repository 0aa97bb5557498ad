"""Plain PyTorch K-EXAONE-236B-A23B (LG AI Research) decoder stage for the
benchmark's reference: the EXAONE 4 block, the sigmoid-routed experts of
a held share with the shared expert, a whole stage's forward, and the
calibration statistics CURing takes from it.

Float32, one sequence at a time, no kernels of the program, no cache and
no batching; TF32 is off inside :func:`no_tf32` (every entry point here
runs under it). The configuration ``m`` is the benchmark's config file
(the source's own key names): ``layer_types`` and ``mlp_layer_types``
give each layer's kind, ``num_experts`` the experts held here and
``router_experts`` the experts the router scores, ``expert_first`` the
first held one.

The block follows EXAONE 4 (arXiv:2507.11407 and its transformers
``Exaone4`` code; the config does not state it): no norm on a sub-block's
input, RMSNorm on its output before the residual add; q / k RMSNorm per
head before RoPE; RoPE (split-half, ``rope_theta``) on the sliding-window
layers, whose queries see the last ``sliding_window`` positions, and none
on the full layers. The MoE follows DeepSeek-V3's sigmoid router as the
config's keys name it: f32 logits, sigmoid scores, the top
``num_experts_per_tok`` renormalized (``norm_topk_prob``) and scaled by
``routed_scaling_factor``; SwiGLU experts; one shared expert of width
``num_shared_experts * moe_intermediate_size``.

Departures from the published model: no routing selection bias (the
config names no ``topk_method``); no multi-token-prediction layer (it
lives on the last stage); of each MoE layer only the held experts add
their part, the absent ones nothing (one chip's share under expert
parallelism, without the exchange), and the held share's part is what
goes on to the next layer. ``quant="fp8"`` is the control: every input
and weight of the MoE layer, and its hidden activations, rounded to
float8 e4m3, the precision step below the configuration's bfloat16.

Imports nothing of the program, of the JAX package or of ``jax``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from reference.model import fp8_round, no_tf32, rms_norm

__all__ = ["no_tf32", "attention", "route", "gate_matrix", "moe", "block",
           "forward", "calibrate", "layer_kinds"]


def layer_kinds(m: Dict, li: int):
    """(window or 0, whether the channel mixer is a MoE) of layer li."""
    win = m["sliding_window"] if m["layer_types"][li] == \
        "sliding_attention" else 0
    return win, m["mlp_layer_types"][li] == "sparse"


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1, split-half rotation."""
    S, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h: torch.Tensor, p: Dict, m: Dict, window: int):
    """One sequence h (S, D) -> (S, D): GQA with q / k RMSNorm per head,
    RoPE on window layers, causal (and windowed) softmax."""
    S = h.shape[0]
    H, K, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    eps = m["rms_norm_eps"]
    q = rms_norm((h @ p["wq"]).view(S, H, hd), p["q_norm"], eps)
    k = rms_norm((h @ p["wk"]).view(S, K, hd), p["k_norm"], eps)
    v = (h @ p["wv"]).view(S, K, hd)
    if window:
        q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    i = torch.arange(S, device=h.device)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    q, k, v = (t.transpose(0, 1)[None] for t in (q, k, v))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       scale=hd ** -0.5)
    return o[0].transpose(0, 1).reshape(S, H * hd) @ p["wo"]


def route(x: torch.Tensor, router: torch.Tensor, m: Dict,
          experts: Optional[torch.Tensor] = None,
          quant: Optional[str] = None):
    """x (T, D) -> (gates (T, k), experts (T, k)) over all
    ``router_experts``: sigmoid of f32 logits, the top k renormalized and
    scaled. Given ``experts`` (T, k), it follows them: the gates are
    those experts' scores, renormalized and scaled. ``quant="fp8"``: x
    and the router rounded to float8 first (the control)."""
    x, router = x.float(), router.float()
    if quant == "fp8":
        x, router = fp8_round(x, -1), fp8_round(router, 0)
    scores = torch.sigmoid(x @ router)
    if experts is None:
        top, idx = torch.topk(scores, m["num_experts_per_tok"], dim=-1)
    else:
        idx = experts.to(x.device).long()
        top = scores.gather(1, idx)
    if m["norm_topk_prob"]:
        top = top / (top.sum(-1, keepdim=True) + 1e-20)
    return top * m["routed_scaling_factor"], idx


def gate_matrix(gates: torch.Tensor, experts: torch.Tensor,
                n: int) -> torch.Tensor:
    """(T, k) gates at (T, k) expert ids -> (T, n) float32: each row's
    gates at its experts, zeros elsewhere."""
    return torch.zeros((gates.shape[0], n), device=gates.device).scatter_(
        1, experts.long(), gates.float())


def swiglu(x, w_gate, w_up, w_down, q8=lambda t: t):
    return q8(q8(F.silu(x @ w_gate)) * q8(x @ w_up)) @ w_down


def moe(x: torch.Tensor, p: Dict, m: Dict, quant: Optional[str] = None,
        experts: Optional[torch.Tensor] = None):
    """The MoE layer on tokens x (T, D): the held experts' part (each held
    expert on the tokens routed to it, gate-weighted) plus the shared
    expert's. ``p["experts"]``: (E_held, D, F) ``w_gate``, ``w_up`` and
    (E_held, F, D) ``w_down``; ``p["shared"]``: its three weights.
    ``experts``: routing to follow (:func:`route`)."""
    def q8(t, dim=-1):
        return fp8_round(t, dim) if quant == "fp8" else t
    x = q8(x)
    gates, idx = route(x, p["router"], m, experts)
    local = idx - m["expert_first"]
    out = torch.zeros_like(x)
    ex = p["experts"]
    for e in range(ex["w_gate"].shape[0]):
        tok, slot = torch.nonzero(local == e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], q8(ex["w_gate"][e], 0), q8(ex["w_up"][e], 0),
                       q8(ex["w_down"][e], 0), q8)
            out.index_add_(0, tok, y * gates[tok, slot, None])
    sh = p["shared"]
    return out + swiglu(x, q8(sh["w_gate"], 0), q8(sh["w_up"], 0),
                        q8(sh["w_down"], 0), q8)


def block(x: torch.Tensor, p: Dict, m: Dict, li: int, keep=None,
          experts: Optional[torch.Tensor] = None):
    """Layer li on x (B, S, D): x + norm1(attention(x)), then x +
    norm2(channel mixer(x)). ``keep(x)`` sees the channel mixer's input;
    a MoE follows the routing ``experts`` (B S, k) where given."""
    win, sparse = layer_kinds(m, li)
    eps = m["rms_norm_eps"]
    a = torch.stack([attention(h, p, m, win) for h in x])
    x = x + rms_norm(a, p["norm1"], eps)
    if keep is not None:
        keep(x)
    xt = x.reshape(-1, x.shape[-1])
    if sparse:
        y = moe(xt, p, m, experts=experts)
    else:
        y = swiglu(xt, p["w_gate"], p["w_up"], p["w_down"])
    return x + rms_norm(y.view_as(x), p["norm2"], eps)


def forward(tokens: torch.Tensor, layer: Callable[[int], Dict],
            embed: torch.Tensor, head: torch.Tensor, final_norm, m: Dict):
    """Logits (B, S, V) of tokens (B, S); ``layer(li)`` gives layer li's
    float32 weights (the names of :func:`block`)."""
    x = embed[tokens].float()
    for li in range(m["num_hidden_layers"]):
        x = block(x, layer(li), m, li)
    return rms_norm(x, final_norm, m["rms_norm_eps"]) @ head.float()


@torch.no_grad()
def calibrate(tokens: torch.Tensor, layer: Callable[[int], Dict],
              embed: torch.Tensor, m: Dict, targets: Sequence[str],
              keep: Sequence[int] = (),
              routing: Optional[Dict[int, torch.Tensor]] = None):
    """One float32 forward of the stage over calibration rows ``tokens``
    (B, S). Returns (per layer {target: sum over the rows of the
    target's squared inputs}, per MoE layer the (E_held,) tokens routed
    to each held expert, {layer in ``keep``: its MoE's input rows (T,
    D)}). ``wq`` / ``wk`` read the residual stream, a MoE's ``w_gate``
    targets the residual stream after attention: ``shared.w_gate`` over
    every row, ``experts.w_gate`` (E_held, D), one row a held expert,
    over the rows routed to it. ``routing`` {layer: (B S, k) experts}:
    routing that the forward and the statistics follow in those layers
    (the program's, so that rounding's flips of near-tied router scores
    do not part the two streams; elsewhere the reference routes)."""
    routing = routing or {}
    x = embed[tokens].float()
    act: List[Dict[str, torch.Tensor]] = []
    routed: Dict[int, torch.Tensor] = {}
    kept: Dict[int, torch.Tensor] = {}
    E = m["num_experts"]
    for li in range(m["num_hidden_layers"]):
        p = layer(li)
        win, sparse = layer_kinds(m, li)
        a: Dict[str, torch.Tensor] = {}
        sq = (x ** 2).sum(dim=(0, 1))
        for t in ("wq", "wk"):
            if t in targets:
                a[t] = sq

        def stats(h, li=li, a=a, p=p, sparse=sparse):
            ht = h.reshape(-1, h.shape[-1])
            sq = (ht ** 2).sum(dim=0)
            if not sparse:
                a["w_gate"] = sq
                return
            a["shared.w_gate"] = sq
            _, idx = route(ht, p["router"], m, routing.get(li))
            local = idx - m["expert_first"]
            hit = torch.stack([(local == e).any(-1) for e in range(E)])
            a["experts.w_gate"] = hit.float() @ (ht ** 2)
            routed[li] = hit.sum(-1)
            if li in keep:
                kept[li] = ht.clone()
        x = block(x, p, m, li, stats, routing.get(li))
        act.append({t: v for t, v in a.items() if t in targets})
    return act, routed, kept

