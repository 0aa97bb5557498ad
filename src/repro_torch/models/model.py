"""Model assembly: init / forward / loss / prefill / decode over layer
groups.

A model's layers are organized as ``cfg.groups = [(pattern, repeats), ...]``.
Parameters for a group are a list of per-pattern-position param dicts whose
leaves carry a leading ``repeats`` axis (the JAX package's layout, so the
bridge maps one tree onto the other). The JAX ``lax.scan`` over repeats is
a Python loop over views here. The dense KV cache of :func:`init_cache`
has the same layout (per group, leaves stacked on a leading ``repeats``
axis); :func:`prefill` and :func:`decode_step` write it in place through
per-layer views and return it.

:func:`forward`, :func:`forward_hidden` and :func:`loss_fn` are
differentiable, as the JAX functions are (training and healing take their
gradients); inference callers run them under their own ``no_grad``.

Every family of the JAX package runs: attention (ATTN / ATTN_LOCAL) and
Mamba-2 (MAMBA) sequence mixers, MLP and MoE channel mixers, and blocks
with no channel mixer (mamba2's ``BlockSpec(MAMBA, "none")``).

``mesh`` is None (one device) or a ``repro_torch.dist.sharding.Placed``
(params placed per their specs: Megatron TP over 'model', FSDP over
'data'). The entry points also take a plain ``DeviceMesh`` with whole
params and place them on entry per ``param_pspecs``
(:func:`place_on_entry`; inference only: a differentiable step places
its params itself, as the train step does). :func:`prefill` and
:func:`decode_step` run on a cache that is this rank's shards per
``cache_pspecs`` (:func:`init_cache` with a ``mesh``): each rank runs its
rows of the batch (the batch axes that divide it) through every layer on
its shards, attention and Mamba on their local heads with the cache's
kv-heads, state heads and conv features (or, where those do not divide
over 'model', through the cache's shard gathered whole), and every rank
gets the global logits. Under a placed mesh the embedding is
vocab-sharded (a masked local lookup summed over 'model'; the
d_model-sharded layout where V does not divide), the logits are
vocab-sharded, and the loss is a vocab-parallel cross-entropy (the max,
the sum of exponentials and the target logit all-reduced over 'model';
no logits all-gather), which is what JAX's one-hot contraction compiles
to. :func:`forward` then returns the logits all-gathered over 'model'.

Activation rematerialization (:func:`apply_groups`) follows JAX's
``_maybe_remat``: with ``cfg.remat``, a group scanned over more than one
repeat (or any group under ``static_loops``) runs each repeat's body
under ``torch.utils.checkpoint`` when autograd records; ``"full"``
checkpoints the whole body, ``"save_mixer_outputs"`` the mixer and the
channel mixer apart, so each block keeps its input and its input plus
the mixer's output (JAX keeps the body input and the tagged mixer and
MLP outputs). The FSDP gathers run inside the checkpointed bodies, so the
backward gathers again. Remat changes memory, never values.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.bridge import flatten_up_to, tree_map, unflatten_as
from repro_torch.configs.base import (
    ATTN, ATTN_LOCAL, MAMBA, MLP, MOE, ModelConfig)
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import (
    P, Placed, cache_pspecs, drop_lead, local_shape, map_specs,
    param_pspecs, place)
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.layers import apply_w, is_model, norm, to_input
from repro_torch.models.mlp import mlp_forward
from repro_torch.models.moe import moe_forward

Params = Dict[str, Any]


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
    if out.is_meta:                        # shapes only: nothing to draw
        return out
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


def _init_moe_experts(gen, cfg: ModelConfig, reps: int, dtype, device):
    """Router (reps, D, E) in f32 over all ``n_experts``; the held experts
    (reps, E_held, D, F) / (reps, E_held, F, D); the shared expert's dense
    MLP when ``n_shared_experts`` is set."""
    E, D = cfg.n_local_experts, cfg.d_model
    F = cfg.moe_d_ff or cfg.d_ff

    def experts(m, n):
        return dense_init(gen, reps * E, m, n, dtype, device).reshape(
            reps, E, m, n)

    p = {"router": dense_init(gen, reps, D, cfg.n_experts, torch.float32,
                              device),
         "w_gate": experts(D, F), "w_up": experts(D, F),
         "w_down": experts(F, D)}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * F
        p["shared"] = {"w_gate": dense_init(gen, reps, D, Fs, dtype, device),
                       "w_up": dense_init(gen, reps, D, Fs, dtype, device),
                       "w_down": dense_init(gen, reps, Fs, D, dtype, device)}
    return p


def _init_mamba(gen, cfg: ModelConfig, reps: int, dtype, device) -> Params:
    """The Mamba-2 mixer's params; A_log, D and dt_bias in f32 (JAX's
    init: A in [1, 16], dt_bias = softplus^-1 of dt ~ logU[1e-3, 0.1])."""
    D = cfg.d_model
    di, N, nh, Kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    f32 = torch.float32

    def w(m, n):
        return dense_init(gen, reps, m, n, dtype, device)

    def zeros(n):
        return torch.zeros((reps, n), dtype=dtype, device=device)

    p = {"w_z": w(D, di), "w_x": w(D, di), "w_B": w(D, N), "w_C": w(D, N),
         "w_dt": w(D, nh),
         "conv_x": w(Kc, di), "conv_x_b": zeros(di),
         "conv_B": w(Kc, N), "conv_B_b": zeros(N),
         "conv_C": w(Kc, N), "conv_C_b": zeros(N)}
    a0 = torch.linspace(1.0, 16.0, nh, dtype=f32, device=device)
    p["A_log"] = torch.log(a0)[None].repeat(reps, 1)
    p["D"] = torch.ones((reps, nh), dtype=f32, device=device)
    u = torch.rand((reps, nh), generator=gen, dtype=f32, device=device)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt0 = torch.exp(lo + (hi - lo) * u)
    p["dt_bias"] = dt0 + torch.log(-torch.expm1(-dt0))
    p["norm_z"] = {"scale": torch.ones((reps, di), dtype=dtype,
                                       device=device)}
    p["w_out"] = w(di, D)
    return p


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
    elif spec.mixer == MAMBA:
        p.update(_init_mamba(gen, cfg, reps, dtype, device))
    if spec.mlp == MLP:
        if cfg.parametric_norm:
            p["norm2"] = {"scale": ones(D)}
        F = cfg.d_ff
        if cfg.gated_mlp:
            p["w_gate"] = dense_init(gen, reps, D, F, dtype, device)
        p["w_up"] = dense_init(gen, reps, D, F, dtype, device)
        p["w_down"] = dense_init(gen, reps, F, D, dtype, device)
    elif spec.mlp == MOE:
        if cfg.parametric_norm:
            p["norm2"] = {"scale": ones(D)}
        p.update(_init_moe_experts(gen, cfg, reps, dtype, device))
    return p


def init_params(seed: int, cfg: ModelConfig, device=None) -> Params:
    """Random params made on ``device`` from one ``torch.Generator`` seeded
    with ``seed``. The stream differs from ``jax.random``'s: tests that
    compare with the JAX package bridge JAX's params instead. On the
    ``meta`` device the tree has the shapes and dtypes and draws nothing
    (``repro_torch.launch.specs.param_specs``)."""
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
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

def _output_norm(cfg) -> bool:
    return cfg.block_norm == "output"


def mixer_input(x, p, cfg):
    """What the block's sequence mixer reads: norm1(x), or under
    ``block_norm="output"`` the residual stream itself."""
    return x if _output_norm(cfg) else norm(x, p.get("norm1"), cfg)


def mixer_output(a, p, cfg):
    """What the sequence mixer's output ``a`` adds to the residual stream:
    ``a``, or norm1(a) under ``block_norm="output"``."""
    return norm(a, p.get("norm1"), cfg) if _output_norm(cfg) else a


def channel_input(x, p, cfg):
    """What the block's channel mixer reads (see :func:`mixer_input`)."""
    return x if _output_norm(cfg) else norm(x, p.get("norm2"), cfg)


def channel_mix(x, p, spec, cfg, mesh=None):
    """x + the block's channel mixer (MLP, MoE, or none)."""
    if spec.mlp == MLP:
        y = mlp_forward(channel_input(x, p, cfg), p, cfg, mesh)
    elif spec.mlp == MOE:
        y = moe_forward(channel_input(x, p, cfg), p, cfg, mesh)
    else:
        return x
    return x + (norm(y, p.get("norm2"), cfg) if _output_norm(cfg) else y)


def place_on_entry(params, cfg, mesh):
    """(params, mesh) as the layers take them: under a plain
    ``DeviceMesh`` the whole ``params`` placed per ``param_pspecs`` and a
    ``Placed`` of them; None or a ``Placed`` pass through. Raises where
    ``params`` require a gradient (a placed leaf's gradient would be this
    rank's block only)."""
    if mesh is None or isinstance(mesh, Placed):
        return params, mesh
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in flatten_up_to(params, params)):
        raise ValueError("gradients under a plain DeviceMesh: place the "
                         "params and pass a Placed (the train step does)")
    specs = param_pspecs(params, cfg, mesh)
    return place(params, specs, mesh), Placed(mesh, specs)


def _seq_mix(x, p, spec, cfg, positions, mesh=None):
    """What the block's sequence mixer adds to x."""
    h = mixer_input(x, p, cfg)
    if spec.mixer in (ATTN, ATTN_LOCAL):
        win = cfg.window if spec.mixer == ATTN_LOCAL else 0
        a = attn.attn_forward(h, p, cfg, positions, window=win, mesh=mesh)
    elif spec.mixer == MAMBA:
        a = mb.mamba_forward(h, p, cfg, mesh=mesh)
    else:
        raise ValueError(spec.mixer)
    return mixer_output(a, p, cfg)


def _call(fn, *args):
    return fn(*args)


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def block_forward(x, p, spec, cfg, positions, mesh=None, wrap=_call):
    """One block; ``wrap`` runs its mixer and its channel mixer (remat's
    ``save_mixer_outputs`` checkpoints each apart)."""
    x = x + wrap(_seq_mix, x, p, spec, cfg, positions, mesh)
    if spec.mlp in (MLP, MOE):
        x = wrap(channel_mix, x, p, spec, cfg, mesh)
    return x


def _embed(params, cfg, batch, mesh=None):
    if cfg.input_mode == "tokens":
        if mesh is not None:
            x = _embed_placed(params["embed"], batch["tokens"],
                              mesh.spec("embed"), mesh.mesh)
        else:
            x = params["embed"][batch["tokens"]]
    else:
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _embed_placed(e, tokens, spec, mesh):
    """The lookup in a placed embedding: vocab-sharded, each rank looks up
    the tokens in its rows (zeros elsewhere) and the rows are summed over
    'model'; d_model-sharded, each rank's columns are all-gathered."""
    if spec is None:
        return e[tokens]
    if is_model(spec[0]):
        Vl = e.shape[0]
        idx = tokens - col.axes_index(mesh, "model") * Vl
        inside = (idx >= 0) & (idx < Vl)
        x = e[torch.where(inside, idx, 0)] * inside[..., None].to(e.dtype)
        return col.reduce_from(x, mesh, "model")
    return col.gather(e[tokens], -1, mesh, "model")


def _unembed(params, cfg, x):
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        return x @ params["embed"].T
    return x @ params["out_head"]


def _unembed_placed(params, cfg, x, lay):
    """(logits, whether they are this rank's vocab columns) under a
    placed mesh: the head (or the tied embedding's transpose) as a weight
    of its spec."""
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        spec = lay.spec("embed")
        w, spec = params["embed"].T, (P(spec[1], spec[0]) if spec else None)
    else:
        w, spec = params["out_head"], lay.spec("out_head")
    x = to_input(x, False, spec, lay.mesh)
    return apply_w(x, w, spec, lay.mesh), is_model(spec[-1] if spec else None)


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None].expand(B, S)


def _unstack(tree, reps: int):
    """``reps`` trees of views, one per repeat of the stacked ``tree``.
    Each leaf is split once (``unbind``), so autograd sums the repeats'
    gradients into the stacked leaf with one ``stack`` instead of one
    zero-filled copy of the whole leaf per repeat."""
    leaves = flatten_up_to(tree, tree)
    cols = [(None,) * reps if a is None else a.unbind(0) for a in leaves]
    return [unflatten_as(tree, [c[r] for c in cols]) for r in range(reps)]


def iter_layers(params, cfg, mesh=None):
    """Yield (layer_idx, spec, per-layer param dict, the layer's mesh) in
    network order; the per-layer leaves are views into the stacked ones,
    and the layer's mesh is a ``Placed`` of its specs under a placed
    ``mesh`` (else None)."""
    li = 0
    for gi, (pattern, reps) in enumerate(cfg.groups):
        views = [_unstack(p, reps) for p in params["groups"][gi]]
        meshes = _layer_meshes(mesh, gi, pattern)
        for r in range(reps):
            for pi, spec in enumerate(pattern):
                yield li, spec, views[pi][r], meshes[pi]
                li += 1


def iter_layer_params(params, cfg):
    """Yield (layer_idx, spec, per-layer param dict) in network order; the
    per-layer leaves are views into the stacked ones."""
    for li, spec, p, _ in iter_layers(params, cfg):
        yield li, spec, p


def _layer_meshes(mesh, gi, pattern):
    """Per pattern position, the mesh its blocks take: a ``Placed`` of
    one repeat's specs under a placed mesh, else ``mesh`` itself."""
    if mesh is None:
        return [None] * len(pattern)
    return [Placed(mesh.mesh, map_specs(drop_lead, s), mesh.local_rows)
            for s in mesh.specs["groups"][gi]]


def _remat_wraps(cfg, reps):
    """(body wrap, sub-body wrap) of a group per JAX's ``_maybe_remat``
    conditions (see the module docstring)."""
    if not (cfg.remat and torch.is_grad_enabled()
            and ((cfg.scan_layers and reps > 1) or cfg.static_loops)):
        return _call, _call
    if cfg.remat_policy == "save_mixer_outputs":
        return _call, _ckpt
    return _ckpt, _call


def apply_groups(x, params, cfg, positions, mesh=None):
    """Run all layer groups over x (each repeat's body rematerialized
    under JAX's conditions)."""
    for gi, (pattern, reps) in enumerate(cfg.groups):
        views = [_unstack(p, reps) for p in params["groups"][gi]]
        meshes = _layer_meshes(mesh, gi, pattern)
        wrap, sub = _remat_wraps(cfg, reps)

        # bound now: a checkpointed body runs again in the backward, when
        # the loop has moved on to later groups
        def body(xc, r, views=views, pattern=pattern, meshes=meshes,
                 sub=sub):
            for pi, spec in enumerate(pattern):
                xc = block_forward(xc, views[pi][r], spec, cfg, positions,
                                   meshes[pi], sub)
            return xc

        for r in range(reps):
            x = wrap(body, x, r)
    return x


def _logits(params, cfg, batch, mesh=None):
    """(logits, whether they are this rank's vocab columns)."""
    x = _embed(params, cfg, batch, mesh)
    positions = _positions(x)
    x = apply_groups(x, params, cfg, positions, mesh)
    x = norm(x, params.get("final_norm"), cfg)
    if mesh is not None:
        return _unembed_placed(params, cfg, x, mesh)
    return _unembed(params, cfg, x), False


def forward(params, cfg: ModelConfig, batch, mesh=None):
    """Full-sequence forward -> logits (B, S, V). Under a ``mesh`` every
    rank passes the same global batch and gets the global logits: every
    layer runs on its shards and the vocab-sharded logits are
    all-gathered over 'model'."""
    params, mesh = place_on_entry(params, cfg, mesh)
    logits, vlocal = _logits(params, cfg, batch, mesh)
    if vlocal:
        logits = col.gather(logits, -1, mesh.mesh, "model")
    return logits


def forward_hidden(params, cfg: ModelConfig, batch, mesh=None):
    """Forward that also returns every block's output hidden state.
    Returns (logits, hidden) with hidden (L+1, B, S, D): the embedding
    output followed by each block's output."""
    params, mesh = place_on_entry(params, cfg, mesh)
    x = _embed(params, cfg, batch, mesh)
    positions = _positions(x)
    collected = [x]
    for gi, (pattern, reps) in enumerate(cfg.groups):
        views = [_unstack(p, reps) for p in params["groups"][gi]]
        meshes = _layer_meshes(mesh, gi, pattern)
        for r in range(reps):
            for pi, spec in enumerate(pattern):
                x = block_forward(x, views[pi][r], spec, cfg, positions,
                                  meshes[pi])
                collected.append(x)
    hidden = torch.stack(collected)
    x = norm(x, params.get("final_norm"), cfg)
    if mesh is None:
        return _unembed(params, cfg, x), hidden
    logits, vlocal = _unembed_placed(params, cfg, x, mesh)
    if vlocal:
        logits = col.gather(logits, -1, mesh.mesh, "model")
    return logits, hidden


class _VocabParallelLL(torch.autograd.Function):
    """Per-token log-likelihood ``logits[label] - logsumexp(logits)`` of f32
    logits sharded over 'model' by vocab (each rank holds a contiguous
    block): the max, the sum of exponentials and the target logit are
    all-reduced over 'model'. The incoming gradient is the same on every
    'model' rank, so each returns its block of (onehot - softmax) * g."""

    @staticmethod
    def forward(ctx, logits, labels, mesh):
        Vl = logits.shape[-1]
        idx = labels - col.axes_index(mesh, "model") * Vl
        inside = (idx >= 0) & (idx < Vl)
        safe = torch.where(inside, idx, 0)
        mx = torch.amax(logits, dim=-1)
        col.all_reduce_max(mx, mesh, "model")
        e = torch.exp(logits - mx[..., None])
        se = col.all_reduce(e.sum(dim=-1), mesh, "model")
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        gold = col.all_reduce(torch.where(inside, gold, 0.0), mesh, "model")
        ctx.save_for_backward(e, se, safe, inside)
        return gold - (torch.log(se) + mx)

    @staticmethod
    def backward(ctx, g):
        e, se, safe, inside = ctx.saved_tensors
        grad = e * (-g / se)[..., None]
        grad.scatter_add_(-1, safe[..., None],
                          torch.where(inside, g, 0.0)[..., None])
        return grad, None, None


def _log_likelihood(logits, labels, vlocal, mesh):
    """ll (B, S) of f32 logits, whole or vocab-sharded."""
    if vlocal:
        return _VocabParallelLL.apply(logits, labels, mesh.mesh)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return gold - lse


def loss_sums(params, cfg, batch, mesh=None):
    """(the masked sum of -log-likelihoods, the mask's count) of ``batch``
    as f32 0-d tensors: the two terms of :func:`loss_fn`'s masked mean
    (an unmasked batch counts every token), which a mesh train step sums
    over its ranks before dividing."""
    logits, vlocal = _logits(params, cfg, batch, mesh)
    ll = _log_likelihood(logits.float(), batch["labels"].long(), vlocal,
                         mesh)
    mask = batch.get("mask")
    if mask is None:
        return -ll.sum(), torch.tensor(float(ll.numel()), device=ll.device)
    mask = mask.float()
    return -(ll * mask).sum(), mask.sum()


def loss_fn(params, cfg, batch, mesh=None):
    """Mean next-token cross-entropy (masked mean when ``batch`` has a
    ``mask``)."""
    params, mesh = place_on_entry(params, cfg, mesh)
    if mesh is not None:
        total, count = loss_sums(params, cfg, batch, mesh)
        return total / torch.clamp(count, min=1.0)
    logits = forward(params, cfg, batch, mesh).float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ll = gold - lse
    mask = batch.get("mask")
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _init_block_cache(spec, cfg, batch, max_len, dtype, device):
    if spec.mixer in (ATTN, ATTN_LOCAL):
        win = cfg.window if spec.mixer == ATTN_LOCAL else 0
        return attn.init_attn_cache(cfg, batch, max_len, win, dtype, device)
    if spec.mixer == MAMBA:
        return mb.init_mamba_cache(cfg, batch, dtype, device)
    return {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               mesh=None):
    """Dense KV cache on ``device`` for ``batch`` sequences of up to
    ``max_len`` tokens: per group, a list of per-pattern-position dicts
    whose leaves carry a leading ``repeats`` axis (the JAX layout). With
    a ``mesh`` (a ``DeviceMesh`` or a ``Placed``) each leaf is this
    rank's shard per ``cache_pspecs``, made at its local shape."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    if mesh is not None:
        m = mesh.mesh if isinstance(mesh, Placed) else mesh
        whole, specs = _cache_layout(cfg, batch, max_len, m)
        return unflatten_as(whole, [
            torch.full(local_shape(t.shape, s, m), -1 if t.dtype ==
                       torch.int32 else 0, dtype=t.dtype, device=device)
            for t, s in zip(flatten_up_to(whole, whole),
                            flatten_up_to(whole, specs))])
    cache = {"groups": []}
    for pattern, reps in cfg.groups:
        group = []
        for spec in pattern:
            one = _init_block_cache(spec, cfg, batch, max_len, dtype, device)
            group.append(tree_map(
                lambda a: a[None].repeat((reps,) + (1,) * a.dim()), one))
        cache["groups"].append(group)
    return cache


@functools.lru_cache(maxsize=32)
def _cache_layout(cfg: ModelConfig, batch: int, max_len: int, mesh):
    """(whole ``meta`` cache, its specs) of a layout (once per layout: a
    decode step asks every step)."""
    whole = init_cache(cfg, batch, max_len, "meta")
    return whole, cache_pspecs(whole, cfg, None, mesh)


def place_cache(cache, cfg: ModelConfig, batch: int, mesh):
    """(cache as a rank's shards, their specs) on ``mesh`` (a
    ``DeviceMesh``) for a ``batch``-row cache: a cache of
    :func:`init_cache` with the mesh passes through, a whole one is
    placed per ``cache_pspecs`` (a copy; the returned cache is the one
    the steps write). Raises on a cache of any other shape."""
    lens = [c["pos"].shape[-1] for g in cache["groups"] for c in g
            if "pos" in c]
    whole, specs = _cache_layout(cfg, batch, max(lens, default=1), mesh)
    leaves = flatten_up_to(whole, cache)
    metas = flatten_up_to(whole, whole)
    specs_flat = flatten_up_to(whole, specs)
    if all(tuple(t.shape) == local_shape(w.shape, s, mesh)
           for t, w, s in zip(leaves, metas, specs_flat)):
        return cache, specs
    if all(tuple(t.shape) == tuple(w.shape) for t, w in zip(leaves, metas)):
        return place(cache, specs, mesh), specs
    raise ValueError("the cache is neither whole nor placed per "
                     "cache_pspecs on this mesh (init_cache(mesh=))")


def row_axes(batch: int, mesh):
    """The batch axes a serving step splits ``batch`` rows over: the dp
    axes where they divide it (the guard of ``batch_pspecs`` and
    ``cache_pspecs``), else none."""
    dp = col.dp_axes(mesh)
    return dp if batch % col.axes_size(mesh, dp) == 0 else ()


def serve_entry(params, cfg: ModelConfig, batch: int, mesh):
    """(params, layout, rows) of a serving step under ``mesh``: the params
    placed per ``param_pspecs`` (:func:`place_on_entry`), a ``Placed`` of
    them whose rows are this rank's when ``rows`` (the batch axes the
    step splits its ``batch`` rows over, :func:`row_axes`) is not
    empty."""
    params, lay = place_on_entry(params, cfg, mesh)
    rows = row_axes(batch, lay.mesh)
    return params, Placed(lay.mesh, lay.specs, bool(rows)), rows


def take_rows(t, rows, mesh):
    """This rank's rows of a global (B, ...) tensor (``rows`` empty: all
    of them)."""
    return col.block(t, 0, mesh, rows) if rows else t


def head_logits(params, cfg: ModelConfig, x, lay, rows):
    """The logits of ``x`` (this rank's rows) under a placed mesh,
    gathered over 'model' (vocab-sharded) and over the ``rows`` axes:
    the global logits on every rank."""
    logits, vlocal = _unembed_placed(params, cfg, x, lay)
    if vlocal:
        logits = col.all_gather_cat(logits, -1, lay.mesh, "model")
    if rows:
        logits = col.all_gather_cat(logits, 0, lay.mesh, rows)
    return logits


def _block_prefill(x, p, c, spec, cfg, positions, mesh=None, cspec=None):
    h = mixer_input(x, p, cfg)
    if spec.mixer in (ATTN, ATTN_LOCAL):
        win = cfg.window if spec.mixer == ATTN_LOCAL else 0
        a, c = attn.attn_prefill(h, p, cfg, positions, c, window=win,
                                 mesh=mesh, cache_spec=cspec)
    elif spec.mixer == MAMBA:
        a, c = mb.mamba_prefill(h, p, cfg, c, mesh=mesh, cache_spec=cspec)
    else:
        raise ValueError(spec.mixer)
    return channel_mix(x + mixer_output(a, p, cfg), p, spec, cfg, mesh), c


def _block_decode(x, p, c, spec, cfg, pos, mesh=None, cspec=None):
    h = mixer_input(x, p, cfg)
    if spec.mixer in (ATTN, ATTN_LOCAL):
        win = cfg.window if spec.mixer == ATTN_LOCAL else 0
        a, c = attn.attn_decode(h, p, cfg, c, pos, window=win, mesh=mesh,
                                cache_spec=cspec)
    elif spec.mixer == MAMBA:
        a, c = mb.mamba_decode(h, p, cfg, c, mesh=mesh, cache_spec=cspec)
    else:
        raise ValueError(spec.mixer)
    return channel_mix(x + mixer_output(a, p, cfg), p, spec, cfg, mesh), c


def _apply_groups_cached(x, params, cache, cfg, block_fn, mesh=None,
                         cache_specs=None):
    """The prefill/decode layer loop: a Python loop over every group's
    repeats (the JAX package's ``lax.scan``), each layer's params and
    cache taken as views of the stacked leaves, so ``block_fn``'s in-place
    cache writes land in ``cache``. ``mesh``: None, or a ``Placed`` of
    the params, whose cache is this rank's shards per ``cache_specs``
    (:func:`place_cache`). Returns (x, cache)."""
    for gi, (pattern, reps) in enumerate(cfg.groups):
        gp, gc = params["groups"][gi], cache["groups"][gi]
        meshes = _layer_meshes(mesh, gi, pattern)
        cspecs = ([None] * len(pattern) if cache_specs is None else
                  [map_specs(drop_lead, s)
                   for s in cache_specs["groups"][gi]])
        for r in range(reps):
            for pi, spec in enumerate(pattern):
                lp = tree_map(lambda a, r=r: a[r], gp[pi])
                lc = tree_map(lambda a, r=r: a[r], gc[pi])
                x, _ = block_fn(x, lp, lc, spec, cfg, meshes[pi], cspecs[pi])
    return x, cache


def _step_inputs(params, cfg, batch, cache, mesh):
    """(params, batch of this rank's rows, cache, layout, cache specs,
    rows) of a prefill or decode step (see :func:`prefill`)."""
    if mesh is None:
        return params, batch, cache, None, None, ()
    key = "tokens" if "tokens" in batch else "embeds"
    B = batch[key].shape[0]
    params, lay, rows = serve_entry(params, cfg, B, mesh)
    cache, cspecs = place_cache(cache, cfg, B, lay.mesh)
    batch = {k: take_rows(v, rows, lay.mesh) for k, v in batch.items()}
    return params, batch, cache, lay, cspecs, rows


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, cache, mesh=None):
    """Process the prompt; returns (last-position logits (B, V), cache).

    ``mesh``: None, a ``DeviceMesh`` (whole params placed per
    ``param_pspecs`` on entry) or a ``Placed`` of placed params. Under a
    mesh every rank passes the same global batch and gets the global
    logits; the cache is this rank's shards per ``cache_pspecs``
    (``init_cache(mesh=)``; a whole cache is placed on entry, and the
    returned cache is the one written). Each rank runs its rows of the
    batch (the batch axes that divide it, as the cache's batch dim) on
    its shards of every layer."""
    params, batch, cache, lay, cspecs, rows = _step_inputs(
        params, cfg, batch, cache, mesh)
    x = _embed(params, cfg, batch, lay)
    positions = _positions(x)

    def block_fn(xc, p, c, spec, cfg, mesh, cspec):
        return _block_prefill(xc, p, c, spec, cfg, positions, mesh, cspec)

    x, cache = _apply_groups_cached(x, params, cache, cfg, block_fn, lay,
                                    cspecs)
    x = norm(x, params.get("final_norm"), cfg)
    if lay is None:
        return _unembed(params, cfg, x[:, -1:, :])[:, 0, :], cache
    return head_logits(params, cfg, x[:, -1:, :], lay, rows)[:, 0, :], cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch, cache, pos, mesh=None):
    """One decode step. batch: tokens (B, 1); pos (B, 1) absolute
    positions. Returns (logits (B, V), cache). ``mesh``: as
    :func:`prefill`'s."""
    params, batch, cache, lay, cspecs, rows = _step_inputs(
        params, cfg, batch, cache, mesh)
    if lay is not None:
        pos = take_rows(pos, rows, lay.mesh)
    x = _embed(params, cfg, batch, lay)

    def block_fn(xc, p, c, spec, cfg, mesh, cspec):
        return _block_decode(xc, p, c, spec, cfg, pos, mesh, cspec)

    x, cache = _apply_groups_cached(x, params, cache, cfg, block_fn, lay,
                                    cspecs)
    x = norm(x, params.get("final_norm"), cfg)
    if lay is None:
        return _unembed(params, cfg, x)[:, 0, :], cache
    return head_logits(params, cfg, x, lay, rows)[:, 0, :], cache
