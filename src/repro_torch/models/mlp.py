"""Channel mixers: gated (SwiGLU/GeGLU) and plain 2-layer MLPs.

All matmuls go through ``apply_w`` so CUR-compressed weights drop in.
"""
from __future__ import annotations

from repro_torch.models.layers import act_fn, apply_w


def mlp_forward(x, p, cfg):
    act = act_fn(cfg.mlp_act)
    if cfg.gated_mlp:
        g = act(apply_w(x, p["w_gate"]))
        u = apply_w(x, p["w_up"])
        return apply_w(g * u, p["w_down"])
    h = act(apply_w(x, p["w_up"]))
    return apply_w(h, p["w_down"])
