"""Mixture-of-Experts channel mixer (``repro.models.moe``).

Three implementations, selected by ``cfg.moe_impl`` and the mesh, as in
the JAX package:

  - ``dense`` (and any call without a mesh): every expert applied to
    every token, the top-k outputs gathered and weighted by the
    renormalized gates. That costs E / k times the routed FLOPs; it is the
    oracle the distributed paths are held to.

  - ``a2a`` with E % model == 0 and the sequence divisible by the model
    axis: expert parallelism. Tokens are sequence-sharded over 'model',
    sorted by destination expert, packed into fixed-capacity per-rank
    buffers, exchanged with an all-to-all, processed by the local expert
    slice as batched GEMMs over only the routed tokens, and returned by a
    second all-to-all. Capacity overflow tokens are dropped (GShard
    semantics); the residual connection carries them.

  - ``a2a`` otherwise (E < model, or decode's S == 1): expert-TP. Every
    rank routes all its tokens with all experts, the intermediate dim F
    sliced over 'model'; dispatch is local (sort + capacity buffer), the
    outputs are summed over 'model'.

The JAX package runs the two bodies under ``shard_map``; the port keeps
its contract explicitly (``repro_torch.dist.collectives``): each rank
takes its block of ``x`` per JAX's ``x_spec``, runs the body on its
experts (or its F columns) with the 'model' group's collectives, and
all-gathers the global (B, S, D). The collectives carry gradients, so a
train step runs through the bodies. The mesh is a
``repro_torch.dist.sharding.Placed``: the bodies take the placed local
expert weights, their FSDP dim gathered over 'data' (the model's entry
points place whole params under a plain ``DeviceMesh``).

Routing: softmax-then-top-k with renormalized gates (Mixtral convention),
or sigmoid scores renormalized over the top k and scaled
(``cfg.moe_scoring``, ``cfg.routed_scaling``; DeepSeek-V3 / K-EXAONE).

A held share (``cfg.experts_held``: experts ``expert_first ..`` of the
``n_experts`` the router scores, one device's share under expert
parallelism, without the exchange) runs as ``dense`` over the held
experts; a token's picks of absent experts add nothing. Expert stacks
may be CUR dicts ``{"CU": (E, D, r), "R": (E, r, F)}``
(``core.compress`` CURs experts one by one and restacks them); every
expert product goes through :func:`_expert_mm`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import collectives as col
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import act_fn, gather_fsdp, is_model
from repro_torch.models.mlp import mlp_forward


def route(xt, router, k: int):
    """xt (T, D) -> (gates (T, k) f32, experts (T, k) int64).

    The logits are taken in x's dtype and softmaxed in f32, as in JAX.
    The top k come from a stable descending sort, so that equal
    probabilities pick the lower expert index first, as ``jax.lax.top_k``
    does (``torch.topk`` promises no order among ties)."""
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    return _top_k(probs, k)


def route_sigmoid(xt, router, k: int):
    """DeepSeek-V3's router: f32 logits, each expert's score their
    sigmoid; the top k (as :func:`route` takes them) renormalized."""
    return _top_k(torch.sigmoid(xt.float() @ router.float()), k)


def _top_k(probs, k: int):
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi


def route_cfg(xt, router, cfg):
    """The config's router (``moe_scoring``: ``softmax`` :func:`route`,
    ``sigmoid`` :func:`route_sigmoid`), its gates scaled by
    ``routed_scaling``."""
    if cfg.moe_scoring not in ("softmax", "sigmoid"):
        raise ValueError(cfg.moe_scoring)
    fn = route_sigmoid if cfg.moe_scoring == "sigmoid" else route
    gates, experts = fn(xt, router, cfg.n_experts_per_tok)
    if cfg.routed_scaling != 1.0:
        gates = gates * cfg.routed_scaling
    return gates, experts


# (E, T, F) elements of one token chunk's expert activations: long
# prompts run in chunks of tokens so the temporaries stay bounded (512 MB
# a tensor in bf16); a token's result does not depend on its chunk but
# for the summation order a GEMM picks by its row count
CHUNK_ELEMS = 1 << 28


def _experts(xt, experts, gates, p, act):
    """The routed output of tokens xt (T, D): every expert applied, the
    top-k gathered and weighted. The products keep the expert axis
    leading, (E, T, .), so no operand is permuted."""
    g = act(_expert_mm(xt, p["w_gate"]))                    # (E, T, F)
    u = _expert_mm(xt, p["w_up"])
    y = _expert_mm(g * u, p["w_down"])                      # (E, T, D)
    tok = torch.arange(xt.shape[0], device=xt.device)[:, None]
    sel = y[experts, tok]                                   # (T, k, D)
    return (sel * gates[:, :, None].to(sel.dtype)).sum(dim=1)


def moe_dense(x, p, cfg):
    """x (B, S, D) -> (B, S, D): the routed experts' part (all held
    experts on all tokens) plus the shared expert's MLP."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    out = _routed_dense(xt, p, cfg)
    if cfg.n_shared_experts:
        out = out + mlp_forward(xt, p["shared"], cfg)
    return out.reshape(B, S, D)


def _cols(w) -> int:
    """Output width of a dense expert stack or of a CUR one."""
    return (w["R"] if isinstance(w, dict) else w).shape[-1]


def _routed_dense(xt, p, cfg):
    """moe_dense's routed part on tokens xt (T, D), in token chunks. Of a
    held share, a pick of an absent expert gets gate 0."""
    T = xt.shape[0]
    act = act_fn(cfg.mlp_act)
    gates, experts = route_cfg(xt, p["router"], cfg)
    E, F = cfg.n_local_experts, _cols(p["w_gate"])
    if cfg.experts_held:
        slot = _held_slots(experts, cfg)
        gates = torch.where(slot < E, gates, torch.zeros_like(gates))
        experts = slot.clamp(max=E - 1)
    step = max(1, CHUNK_ELEMS // (E * F))
    return torch.cat([_experts(xt[t:t + step], experts[t:t + step],
                               gates[t:t + step], p, act)
                      for t in range(0, T, step)])


def _held_slots(experts, cfg):
    """(T, k) routed expert ids -> (T, k) index of each into the held
    share, ``n_local_experts`` where the expert is not held here."""
    E = cfg.n_local_experts
    local = experts - cfg.expert_first
    return torch.where((local >= 0) & (local < E), local, E)


def expert_act_sq(h, router, cfg):
    """WANDA statistics of the held experts' inputs: h (B, S, D) ->
    (sum over the tokens routed to each held expert of their squared
    inputs (E, D) f32, each held expert's token count (E,) f32)."""
    xt = h.reshape(-1, h.shape[-1])
    E = cfg.n_local_experts
    _, experts = route_cfg(xt, router, cfg)
    slot = _held_slots(experts, cfg)
    hit = torch.zeros((xt.shape[0], E + 1), dtype=torch.float32,
                      device=xt.device)
    hit.scatter_(1, slot, 1.0)
    hit = hit[:, :E]
    return hit.T @ xt.float().square(), hit.sum(dim=0)


# ---------------------------------------------------------------------------
# distributed paths (the shard_map bodies)
# ---------------------------------------------------------------------------

def _rank_within_expert(fe):
    """For each assignment, its occurrence rank within its expert id (in
    assignment order). O(A log A): a stable sort, then each run's start by
    a running max, as JAX's ``associative_scan(maximum)``."""
    A = fe.shape[0]
    order = torch.sort(fe, stable=True).indices
    fe_s = fe[order]
    idx = torch.arange(A, device=fe.device)
    is_start = torch.ones(A, dtype=torch.bool, device=fe.device)
    is_start[1:] = fe_s[1:] != fe_s[:-1]
    start_pos = torch.cummax(torch.where(is_start, idx, -1), dim=0).values
    rank = torch.empty(A, dtype=torch.int32, device=fe.device)
    rank[order] = (idx - start_pos).to(torch.int32)
    return rank


def _expert_mm(h, w):
    """Batched expert matmul supporting CUR-factorized expert weights.
    h (E, C, D); w dense (E, D, F) or {"C","U0","dU","R"} / {"CU","R"}
    stacks."""
    if isinstance(w, dict) and ("C" in w or "CU" in w):
        if "CU" in w:
            t = torch.matmul(h, w["CU"].to(h.dtype))
        else:
            u = (w["U0"] + w["dU"]).to(h.dtype)
            t = torch.matmul(torch.matmul(h, w["C"].to(h.dtype)), u)
        return torch.matmul(t, w["R"].to(h.dtype))
    return torch.matmul(h, w)


def _expert_ffn(h, wg, wu, wd, act):
    """h (E, C, D) x weights (E, D, F) / (E, F, D) -> (E, C, D)."""
    g = act(_expert_mm(h, wg))
    u = _expert_mm(h, wu)
    return _expert_mm(g * u, wd)


def _assignments(xs, router, cfg):
    """Routing of xs (B, S, D)'s T tokens: (xt (T, D), experts fe (A,),
    gates fg (A,), token ft (A,), rank within expert (A,), capE) for the
    A = T * k assignments, token-major."""
    k = cfg.n_experts_per_tok
    T = xs.shape[0] * xs.shape[1]
    xt = xs.reshape(T, xs.shape[-1])
    gates, experts = route_cfg(xt, router, cfg)
    fe = experts.reshape(-1)
    ft = torch.arange(T, device=xs.device).repeat_interleave(k)
    capE = max(1, math.ceil(T * k * cfg.capacity_factor / cfg.n_experts))
    return xt, fe, gates.reshape(-1), ft, _rank_within_expert(fe), capE


def _combine(y_a, keep, fg, ft, T):
    """Sum of the kept assignments' outputs, gate-weighted, per token
    (``segment_sum``)."""
    y_a = torch.where(keep[:, None], y_a, torch.zeros_like(y_a))
    y_a = y_a * fg[:, None].to(y_a.dtype)
    return torch.zeros((T, y_a.shape[-1]), dtype=y_a.dtype,
                       device=y_a.device).index_add(0, ft, y_a)


def _moe_body_a2a(xs, router, wg, wu, wd, *, cfg, n, mesh):
    """Expert-parallel body. xs (B, S_loc, D); wg/wu/wd (E_loc, D, F) /
    (E_loc, F, D); all-to-alls over 'model' (n ranks)."""
    E_loc = cfg.n_experts // n
    B, S, D = xs.shape
    xt, fe, fg, ft, rank, capE = _assignments(xs, router, cfg)
    capB = E_loc * capE
    dst = fe // E_loc
    slot = (fe % E_loc) * capE + rank
    keep = rank < capE
    slot_eff = torch.where(keep, slot, capB)          # capB: the drop row
    send = torch.zeros((n, capB + 1, D), dtype=xs.dtype, device=xs.device)
    send = send.index_put((dst, slot_eff), xt[ft])[:, :capB]
    recv = col.all_to_all(send.reshape(n * capB, D), mesh, "model")
    # slot layout per source: (E_loc, capE); regroup by local expert
    h = recv.reshape(n, E_loc, capE, D).transpose(0, 1)
    h = h.reshape(E_loc, n * capE, D)
    y = _expert_ffn(h, wg, wu, wd, act_fn(cfg.mlp_act))
    back = y.reshape(E_loc, n, capE, D).transpose(0, 1)
    ret = col.all_to_all(back.reshape(n * capB, D), mesh, "model")
    y_a = ret.reshape(n, capB, D)[dst, slot_eff.clamp(0, capB - 1)]
    return _combine(y_a, keep, fg, ft, B * S).reshape(B, S, D)


def _moe_body_tp(xs, router, wg, wu, wd, *, cfg, mesh):
    """Expert-TP body (E < model axis). xs (B, S, D) replicated over
    'model'; wg/wu (E, D, F_loc), wd (E, F_loc, D). The output is summed
    over 'model'."""
    E = cfg.n_experts
    B, S, D = xs.shape
    xt, fe, fg, ft, rank, capE = _assignments(xs, router, cfg)
    keep = rank < capE
    slot_eff = torch.where(keep, rank, capE)
    buf = torch.zeros((E, capE + 1, D), dtype=xs.dtype, device=xs.device)
    buf = buf.index_put((fe, slot_eff), xt[ft])[:, :capE]
    y = _expert_ffn(buf, wg, wu, wd, act_fn(cfg.mlp_act))  # partial over F
    y_a = y[fe, slot_eff.clamp(0, capE - 1)]
    out = _combine(y_a, keep, fg, ft, B * S)
    return col.reduce_from(out, mesh, "model").reshape(B, S, D)


def _x_spec(shape, cfg, mesh, local_rows: bool = False):
    """shard_map's spec of x (B, S, D) on ``mesh``: (per-dim axes of B and
    S, whether the a2a body runs, the batch axes ``b_ax``). With
    ``local_rows`` the rows are this rank's already: no batch axis."""
    n = axis_sizes(mesh)["model"]
    dp = () if local_rows else col.dp_axes(mesh)
    dp_size = col.axes_size(mesh, dp)
    B, S = shape[:2]
    # small/indivisible batches (long-context B=1) replicate over 'data'
    b_ax = dp if (B % dp_size == 0 and B >= dp_size) else ()
    # a2a needs the sequence dim divisible by the model axis (it shards
    # tokens over 'model'); decode steps (S == 1) use the TP body instead
    fsdp_layout = getattr(cfg, "layout", "tp") == "fsdp"
    if cfg.n_experts % n == 0 and (S % n == 0 or fsdp_layout):
        if fsdp_layout and b_ax and B % (dp_size * n) == 0 \
                and B >= dp_size * n:
            # batch already spans (data, model): tokens arrive fully split
            return (dp + ("model",), ()), True, b_ax
        return (b_ax, "model"), True, b_ax
    return (b_ax, ()), False, b_ax


_EXPERTS = ("w_gate", "w_up", "w_down")


def _whole(w, spec, mesh):
    """A placed weight (tree) gathered whole on every rank: its FSDP dims
    with the reduce-scattering gather, its 'model' dims with ``gather``
    (every 'model' rank then computes the same thing with it)."""
    if isinstance(w, dict):
        return {k: _whole(v, spec.get(k) if isinstance(spec, dict) else None,
                          mesh) for k, v in w.items()}
    w = gather_fsdp(w, spec, mesh)
    for d, entry in enumerate(spec or ()):
        if is_model(entry):
            w = col.gather(w, d, mesh, "model")
    return w


def _tp_from_ep(w, name, mesh):
    """An expert-parallel placed weight (E_loc, ., .) in the TP body's
    layout, all E experts and this rank's F columns (a sequence the a2a
    body cannot split over 'model'). The scatter's backward all-gathers,
    so the gather's backward sees the same cotangent on every rank."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "CUR expert weights placed expert-parallel in the TP body")
    w = col.gather(w, 0, mesh, "model")
    return col.scatter(w, 1 if name == "w_down" else 2, mesh, "model")


def moe_forward(x, p, cfg, mesh=None):
    """Dispatch on impl + mesh. x (B, S, D) -> (B, S, D), the same global
    tensor on every rank of ``mesh``: None, or a ``Placed`` of this
    layer's params (a DeviceMesh with a 'model' axis and, optionally,
    'data' / 'pod' batch axes; see the module docstring)."""
    if mesh is None:
        return moe_dense(x, p, cfg)
    if cfg.experts_held:
        raise NotImplementedError(
            f"{cfg.name}: a held share of experts runs without a mesh only "
            "(placed expert-parallel CUR of experts is not built)")
    lay, mesh = mesh, mesh.mesh
    if cfg.moe_impl == "dense":
        w = {k: _whole(p[k], lay.spec(k), mesh)
             for k in ("router",) + _EXPERTS}
        B, S, D = x.shape
        out = _routed_dense(x.reshape(B * S, D), w, cfg).reshape(B, S, D)
        if cfg.n_shared_experts:
            out = out + mlp_forward(x, p["shared"], cfg, lay.sub("shared"))
        return out
    x_spec, a2a, b_ax = _x_spec(x.shape, cfg, mesh, lay.local_rows)
    # the router's gradient is partial on every rank (each routes its own
    # tokens, or its F columns' share of the gates' gradient)
    router = gather_fsdp(p["router"], lay.spec("router"), mesh)
    router = col.copy_to(router, mesh, b_ax + ("model",))
    w = [gather_fsdp(p[k], lay.spec(k), mesh) for k in _EXPERTS]
    if not a2a and is_model((lay.spec("w_gate") or (None,))[0]):
        w = [_tp_from_ep(a, k, mesh) for a, k in zip(w, _EXPERTS)]
    if a2a:
        n = axis_sizes(mesh)["model"]

        def body(xs):
            return _moe_body_a2a(xs, router, *w, cfg=cfg, n=n, mesh=mesh)
    else:
        def body(xs):
            xs = col.copy_to(xs, mesh, "model")
            return _moe_body_tp(xs, router, *w, cfg=cfg, mesh=mesh)
    xs = x
    for d, axes in enumerate(x_spec):
        if axes:
            xs = col.scatter(xs, d, mesh, axes)
    out = body(xs)
    for d, axes in enumerate(x_spec):
        if axes:
            out = col.gather(out, d, mesh, axes)
    if cfg.n_shared_experts:
        out = out + mlp_forward(x, p["shared"], cfg, lay.sub("shared"))
    return out
