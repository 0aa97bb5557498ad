"""Channel mixers: gated (SwiGLU/GeGLU) and plain 2-layer MLPs.

All matmuls go through ``apply_w`` so CUR-compressed weights drop in.
Under a placed mesh (``mesh``: a ``repro_torch.dist.sharding.Placed`` of
the block) ``w_gate`` / ``w_up`` are column-parallel and ``w_down``
row-parallel: the hidden activation stays this rank's columns between
them, and ``w_down``'s partial output is all-reduced over 'model'.
"""
from __future__ import annotations

from repro_torch.dist import collectives as col
from repro_torch.models.layers import act_fn, apply_w, out_local, to_input


def mlp_forward(x, p, cfg, mesh=None):
    act = act_fn(cfg.mlp_act)
    if mesh is None:
        if cfg.gated_mlp:
            g = act(apply_w(x, p["w_gate"]))
            u = apply_w(x, p["w_up"])
            return apply_w(g * u, p["w_down"])
        h = act(apply_w(x, p["w_up"]))
        return apply_w(h, p["w_down"])
    m = mesh.mesh

    def col_out(name):
        spec = mesh.spec(name)
        return apply_w(x, p[name], spec, m), out_local(spec)

    u, local = col_out("w_up")
    if cfg.gated_mlp:
        g, g_local = col_out("w_gate")
        if g_local != local:         # align both on whole columns
            g = col.gather(g, -1, m, "model") if g_local else g
            u = col.gather(u, -1, m, "model") if local else u
            local = False
        h = act(g) * u
    else:
        h = act(u)
    h = to_input(h, local, mesh.spec("w_down"), m)
    return apply_w(h, p["w_down"], mesh.spec("w_down"), m)
