"""Faults planted under the MoE CURing cell's timed path and set-up
(``harness/cure_moe.py``), each where the program handles experts; the
check has to read each one above its limit. ``FAULTS[name] = (plant,
number)`` as in ``tools/faults.py``: ``plant(setattr)`` patches the
program through a ``setattr`` that its caller undoes, and ``number`` is
the check's number that the fault has to fail.
"""
import importlib

import torch


def all_token_expert_stats(patch):
    """Each held expert's WANDA statistics are taken over every token, not
    over the tokens routed to it."""
    calibrate = importlib.import_module("repro_torch.core.calibrate")

    def every(h, router, cfg):
        xt = h.reshape(-1, h.shape[-1]).float()
        E = cfg.n_local_experts
        sq = xt.square().sum(dim=0)
        n = torch.full((E,), float(xt.shape[0]), device=xt.device)
        return sq.expand(E, -1).clone(), n
    patch(calibrate, "expert_act_sq", every)


def softmax_routing(patch):
    """The router scores by softmax where the config asks for sigmoid."""
    from repro_torch.models import moe

    def softmax(xt, router, cfg):
        gates, experts = moe.route(xt, router, cfg.n_experts_per_tok)
        return gates * cfg.routed_scaling, experts
    patch(moe, "route_cfg", softmax)


def gate_scale_dropped(patch):
    """The routed experts' gates lose ``routed_scaling_factor``."""
    from repro_torch.models import moe

    def unscaled(xt, router, cfg):
        return moe.route_sigmoid(xt, router, cfg.n_experts_per_tok)
    patch(moe, "route_cfg", unscaled)


def neighbour_expert_leaf(patch):
    """Each routed expert's C U and R are those of the next expert in its
    stack (its reported indices stay its own)."""
    from repro_torch.core import compress
    orig = compress._compress_batched

    def shifted(work, cur_cfg):
        out = orig(work, cur_cfg)
        stacks = {}
        for i, (_, info) in enumerate(out):
            if info.expert is not None:
                stacks.setdefault((info.layer, info.name), []).append(i)
        moved = list(out)
        for idxs in stacks.values():
            for a, b in zip(idxs, idxs[1:] + idxs[:1]):
                moved[a] = (out[b][0], out[a][1])
        return moved
    patch(compress, "_compress_batched", shifted)


FAULTS = {
    "all_token_expert_stats": (all_token_expert_stats, "wanda_gap"),
    "softmax_routing": (softmax_routing, "routing_gap"),
    # the same fault seen downstream, in the experts' calibration statistics
    "softmax_routing_statistics": (softmax_routing, "wanda_gap"),
    "neighbour_expert_leaf": (neighbour_expert_leaf, "fold_gap"),
    "gate_scale_dropped": (gate_scale_dropped, "expert_forward_gap"),
}
