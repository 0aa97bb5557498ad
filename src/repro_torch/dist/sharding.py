"""Sharding rules: PartitionSpec trees for every distributed artifact
(``repro.dist.sharding`` in the JAX package, whose rules these are, leaf
for leaf).

Layout contract, derived per-leaf from the key path:

  - Megatron TP over 'model': column-parallel projections (wq/wk/wv,
    w_gate/w_up, mamba in-projections) shard their output dim; the
    matching row-parallel projections (wo, w_down, w_out) shard their
    input dim, so each block needs one all-reduce per mixer/MLP.
  - ``cfg.fsdp`` additionally shards the *other* matrix dim over 'data'
    (ZeRO-3 style weight sharding).
  - Embeddings are vocab-sharded over 'model'; falls back to
    d_model-sharding when the vocab does not divide (e.g. mamba2's 50280).
  - MoE experts: expert-parallel over 'model' when E % model == 0
    (kimi 384e, jamba 16e), expert-TP over the intermediate dim otherwise
    (mixtral 8e over 16).
  - CUR-factorized dict leaves ({C, U0, dU, R} healing form, {CU, R}
    folded serving form): C/CU inherit the dense weight's input-dim
    sharding, R inherits the output-dim sharding, U0/dU (r, r) replicate.
  - Optimizer moments mirror the param spec; int8-quantized state shards
    codes like the param and row-scales like the param minus its last
    axis (see ``optim.adamw.state_spec_from_param``).

Every assignment is guarded by divisibility: an axis whose size does not
divide the dim degrades to ``None`` (replicated). On the multi-pod (pod,
data, model) mesh, parameters keep their (data, model) layout; batches
shard over ('pod', 'data').

A spec is the port's :class:`PartitionSpec`: a tuple with one entry per
tensor dim, each an axis name, a tuple of axis names (major first) or
``None``; a ``None`` spec is a replicated leaf. ``mesh`` is a
``DeviceMesh`` or an :class:`AbstractMesh`. :func:`to_placements` turns a
spec into DTensor placements and :func:`distribute` places a tree by its
specs as DTensors.

The model and the train step run on plain tensors: :func:`place` gives
each rank its local shard of every leaf (the slice JAX's
``NamedSharding`` gives the device at the same mesh position), and a
:class:`Placed` (a mesh with the params' specs) tells the model functions
that their params are such shards (``jax.jit``'s ``in_shardings``).
:func:`to_named` gives the per-leaf (mesh, spec) pairs that
``CheckpointManager.restore(shardings=)`` reads into, and :func:`unplace`
all-gathers a placed tree back to whole tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.bridge import flatten_up_to, unflatten_as
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.collectives import (
    all_gather_cat, axes_size, block, entry_axes, spec_axes)
from repro_torch.launch.mesh import AbstractMesh, axis_sizes
from repro_torch.optim.adamw import (
    STATE_FULL_KEYS, STATE_SCALE_KEYS, state_spec_from_param)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: per tensor dim an axis name, a tuple
    of axis names or ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# CUR dict leaf keys (healing and folded serving forms)
_CUR_FULL = ("C", "CU")          # inherit input-dim sharding
_CUR_RIGHT = ("R",)              # inherit output-dim sharding
_CUR_CORE = ("U0", "dU")         # (r, r) core: replicated
_CUR_KEYS = frozenset(_CUR_FULL + _CUR_RIGHT + _CUR_CORE)
_STATE_KEYS = frozenset(STATE_FULL_KEYS) | frozenset(STATE_SCALE_KEYS)

# column-parallel (..., in, out) weights: shard out over 'model', in over
# 'data' when fsdp
_COL_PARALLEL = frozenset((
    "wq", "wk", "wv",                     # attention projections
    "w_z", "w_x", "w_B", "w_C", "w_dt",   # mamba in-projections
))
# row-parallel (..., in, out) weights: shard in over 'model', out over 'data'
_ROW_PARALLEL = frozenset(("wo", "w_out"))


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    """AbstractMesh((16, 16), ("data", "model")): no devices."""
    return AbstractMesh(tuple(shape), tuple(axes))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _axis_size(mesh, ax) -> int:
    axes = ax if isinstance(ax, tuple) else (ax,)
    shape = axis_sizes(mesh)
    size = 1
    for a in axes:
        if a not in shape:
            return 0          # axis not on this mesh -> never divisible
        size *= shape[a]
    return size


def _guard(shape: Tuple[int, ...], entries: Sequence[Any], mesh) -> P:
    """Align ``entries`` to the trailing dims of ``shape``; replace any
    non-divisible assignment with None. Returns a full-rank PartitionSpec
    (or None when nothing is sharded)."""
    entries = list(entries)[-len(shape):] if len(shape) else []
    full = [None] * (len(shape) - len(entries)) + entries
    out = []
    for dim, ax in zip(shape, full):
        if ax is None:
            out.append(None)
            continue
        size = _axis_size(mesh, ax)
        out.append(ax if (size and dim % size == 0) else None)
    if not any(a is not None for a in out):
        return None
    return P(*out)


def _dp_axes(mesh):
    """Batch axes: ('pod', 'data') on the multi-pod mesh, else 'data'."""
    if "pod" in axis_sizes(mesh):
        return ("pod", "data")
    return "data"


def _block_spec_at(path, cfg: ModelConfig):
    """BlockSpec for a leaf under params['groups'][gi][pi], else None."""
    for i, k in enumerate(path):
        if k == "groups" and i + 2 < len(path):
            gi, pi = path[i + 1], path[i + 2]
            if isinstance(gi, int) and isinstance(pi, int):
                try:
                    return cfg.groups[gi][0][pi]
                except (IndexError, TypeError):
                    return None
    return None


def _split_path(path):
    """-> (role key, cur part or None, state part or None).

    The trailing special keys are peeled off in reverse: optimizer-state
    keys sit innermost (moments of a CUR factor look like
    [..., 'wq', 'C', 'm']), CUR factor keys next, and the first ordinary
    key is the weight's role."""
    cur = state = None
    role = None
    for k in reversed(path):
        if not isinstance(k, str):
            continue
        if k in _STATE_KEYS and state is None and cur is None \
                and role is None:
            state = k
            continue
        if k in _CUR_KEYS and cur is None and role is None:
            cur = k
            continue
        role = k
        break
    return role, cur, state


def _dense_core(role: str, path, leaf_shape, cfg: ModelConfig, mesh):
    """Core spec entries for the trailing dims of the *dense* weight named
    ``role`` (2 entries, or 3 for per-expert MoE stacks). None = fully
    replicated leaf."""
    fs = "data" if cfg.fsdp else None
    if role in _COL_PARALLEL:
        return (fs, "model")
    if role in _ROW_PARALLEL:
        return ("model", fs)
    if role == "router":
        return (fs, None)
    if role in ("w_gate", "w_up", "w_down"):
        blk = _block_spec_at(path, cfg)
        moe = (blk is not None and blk.mlp == "moe"
               and "shared" not in path)
        if not moe:
            if role == "w_down":                   # (F, D) row-parallel
                return ("model", fs)
            return (fs, "model")                   # (D, F) column-parallel
        n_model = _axis_size(mesh, "model")
        ep = bool(n_model) and cfg.n_experts % n_model == 0
        if role == "w_down":                       # (E, F, D)
            return ("model", None, fs) if ep else (None, "model", fs)
        # w_gate / w_up: (E, D, F)
        return ("model", fs, None) if ep else (None, fs, "model")
    if role == "embed":
        V = leaf_shape[-2]
        n_model = _axis_size(mesh, "model")
        if n_model and V % n_model == 0:
            return ("model", None)                 # vocab-sharded
        return (None, "model")                     # fallback: shard d_model
    if role == "out_head":
        return (fs, "model")
    return None                                    # norms, biases, scalars


def _leaf_spec(path, leaf, cfg: ModelConfig, mesh) -> Optional[P]:
    shape = tuple(leaf.shape)
    role, cur, state = _split_path(path)
    if role is None:
        return None
    # m_s / v_s scales of a 1-d param collapse to scalars per row; the
    # dense-core shape argument must describe the *param*, so re-derive it
    core_shape = shape
    if state in STATE_SCALE_KEYS:
        core_shape = shape + (1,)
    core = _dense_core(role, path, core_shape, cfg, mesh)
    if core is None:
        return None
    core = list(core)
    if cur in _CUR_FULL:                 # (..., in, r)
        core = core[:-1] + [None]
    elif cur in _CUR_RIGHT:              # (..., r, out)
        core = core[:-2] + [None, core[-1]]
    elif cur in _CUR_CORE:               # (..., r, r)
        core = core[:-2] + [None, None]
    core = state_spec_from_param(core, state) if state else core
    return _guard(shape, core, mesh)


def _walk(node, path, fn):
    if isinstance(node, dict):
        return {k: _walk(v, path + (k,), fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v, path + (i,), fn) for i, v in enumerate(node)]
    if isinstance(node, tuple):
        return tuple(_walk(v, path + (i,), fn) for i, v in enumerate(node))
    if node is None:
        return None
    return fn(path, node)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def param_pspecs(params, cfg: ModelConfig, mesh):
    """PartitionSpec tree mirroring ``params`` (tensors, ``meta`` tensors
    or TensorSpecs). Dense weights follow the TP/FSDP layout contract;
    CUR dict leaves ({C, U0, dU, R} / {CU, R}) are dispatched per factor."""
    return _walk(params, (),
                 lambda path, leaf: _leaf_spec(path, leaf, cfg, mesh))


def draft_param_pspecs(draft_params, cfg: ModelConfig, mesh):
    """Specs for a speculative-decoding DRAFT parameter tree on the same
    mesh as the target's: the same layout contract, whose low CUR ranks
    routinely fail the divisibility guard and replicate."""
    return param_pspecs(draft_params, cfg, mesh)


def opt_state_pspecs(opt_state, cfg: ModelConfig, mesh):
    """Specs for an AdamW state ({'step', 'moments'}): moments inherit the
    mirrored param's spec; int8-quantized codes keep it and their row
    scales drop the last axis."""
    return _walk(opt_state, (),
                 lambda path, leaf: _leaf_spec(path, leaf, cfg, mesh))


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Input-batch specs: batch dim over ('pod',)'data', rest replicated."""
    dp = _dp_axes(mesh)
    B, L = shape.global_batch, shape.seq_len
    specs = {"labels": _guard((B, L), [dp, None], mesh)}
    if cfg.input_mode == "tokens":
        specs["tokens"] = _guard((B, L), [dp, None], mesh)
    else:
        specs["embeds"] = _guard((B, L, cfg.d_model), [dp, None, None], mesh)
    return specs


def shard_batch(batch, cfg: ModelConfig, mesh):
    """This rank's rows of a global (B, L, ...) batch per
    :func:`batch_pspecs` (entries it has no spec for, such as a mask,
    split like the labels)."""
    B, L = batch["labels"].shape[:2]
    specs = batch_pspecs(cfg, ShapeConfig("batch", L, B, "train"), mesh)
    return {k: local_shard(v, specs.get(k, specs["labels"]), mesh)
            for k, v in batch.items()}


def decode_batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(batch specs, pos spec) for one decode step."""
    dp = _dp_axes(mesh)
    B = shape.global_batch
    if cfg.input_mode == "tokens":
        batch = {"tokens": _guard((B, 1), [dp, None], mesh)}
    else:
        batch = {"embeds": _guard((B, 1, cfg.d_model), [dp, None, None],
                                  mesh)}
    pos = _guard((B, 1), [dp, None], mesh)
    return batch, pos


def _cache_leaf_spec(path, leaf, cfg: ModelConfig, mesh):
    """KV / SSM cache leaves. Batch shards over data; one more axis shards
    over 'model', picked by first-divisible priority: kv-heads, then
    head_dim / feature, then cache length."""
    shape = tuple(leaf.shape)
    dp = _dp_axes(mesh)
    key = path[-1] if path and isinstance(path[-1], str) else None
    nd = len(shape)
    if key in ("k", "v") and nd >= 5:          # (reps, B, L, K, hd)
        for cand in ([None, dp, None, "model", None],
                     [None, dp, None, None, "model"],
                     [None, dp, "model", None, None]):
            spec = _guard(shape, cand, mesh)
            if spec is not None and any(a == "model" for a in tuple(spec)):
                return spec
        return _guard(shape, [None, dp, None, None, None], mesh)
    if key == "pos" and nd >= 3:               # (reps, B, L)
        return _guard(shape, [None, dp, None], mesh)
    if key == "state" and nd >= 5:             # (reps, B, nh, hp, N)
        return _guard(shape, [None, dp, "model", None, None], mesh)
    if key in ("conv_x", "conv_B", "conv_C") and nd >= 4:
        return _guard(shape, [None, dp, None, "model"], mesh)
    if nd >= 2:
        return _guard(shape, [None, dp] + [None] * (nd - 2), mesh)
    return None


def cache_pspecs(cache, cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Specs for a prefill/decode cache tree (stacked per layer group)."""
    return _walk(cache, (),
                 lambda path, leaf: _cache_leaf_spec(path, leaf, cfg, mesh))


def _paged_leaf_spec(path, leaf, cfg: ModelConfig, mesh,
                     kernel: bool = False):
    """Paged-pool leaves. Pools (L, n_blocks, bs, K, r): blocks are shared
    by all sequences, so there is no batch axis — one axis shards over
    'model' by first-divisible priority (kv-heads, then feature/rank,
    then the block pool). CUR-KV projections and block tables replicate.

    ``kernel=True`` (the paged_attention kernel's decode): the kernel
    holds whole ``(block_size, r)`` tiles of one kv-head, so kv-heads is
    the ONLY pool axis it can shard; non-divisible kv-heads replicate
    instead of falling back."""
    shape = tuple(leaf.shape)
    key = path[-1] if path and isinstance(path[-1], str) else None
    if key in ("k", "v") and len(shape) == 5:   # (L, nb, bs, K, r)
        cands = [[None, None, None, "model", None]]
        if not kernel:
            cands += [[None, None, None, None, "model"],
                      [None, "model", None, None, None]]
        for cand in cands:
            spec = _guard(shape, cand, mesh)
            if spec is not None and any(a == "model" for a in tuple(spec)):
                return spec
    return None


def paged_cache_pspecs(cache, cfg: ModelConfig, mesh, kernel: bool = False):
    """Specs for a ``repro_torch.serving.paged_cache`` pool tree. Pass
    ``kernel=True`` when the decode step runs the paged_attention kernel
    (kv-head-only pool sharding; see ``_paged_leaf_spec``)."""
    return _walk(cache, (),
                 lambda path, leaf: _paged_leaf_spec(path, leaf, cfg, mesh,
                                                     kernel))


def paged_decode_pspecs(cfg: ModelConfig, batch: int, max_blocks: int, mesh,
                        kernel: bool = False):
    """(tokens, table, ctx_len, active) specs for one paged decode step:
    every slot-batch-dim input, each slot's block-table row included,
    shards over ('pod',)'data'; the pool has no data-axis sharding. The
    layout is the same with and without the kernel."""
    del kernel  # same input layout on both paths; kwarg kept for parity
    dp = _dp_axes(mesh)
    tokens = _guard((batch, 1), [dp, None], mesh)
    table = _guard((batch, max_blocks), [dp, None], mesh)
    ctx = _guard((batch,), [dp], mesh)
    active = _guard((batch,), [dp], mesh)
    return tokens, table, ctx, active


# ---------------------------------------------------------------------------
# placement (NamedSharding in JAX)
# ---------------------------------------------------------------------------

def to_placements(spec, mesh):
    """DTensor placements, one per mesh dim, for ``spec``: ``Shard(d)``
    on each mesh axis that tensor dim ``d`` names, ``Replicate()`` on the
    rest (``None``: all replicated). An entry of several axes shards one
    tensor dim over them major first, which DTensor does in mesh order,
    so its axes must come in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec or ()):
        axes = entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for i in pos:
            out[i] = Shard(d)
    return out


def distribute(tree, specs, mesh):
    """``tree``'s tensors as DTensors on ``mesh`` placed per ``specs``
    (a tree of PartitionSpecs / None of the same structure; the JAX
    package's ``jax.device_put(tree, to_named(specs, mesh))``)."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, spec):
        if isinstance(t, dict):
            return {k: place(t[k], spec[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(place(a, s) for a, s in zip(t, spec))
        if t is None:
            return None
        return distribute_tensor(t, mesh, to_placements(spec, mesh))

    return place(tree, specs)


def local_shard(t, spec, mesh):
    """This rank's block of the global tensor ``t`` under ``spec`` (the
    local tensor ``distribute`` would give, as a view of ``t``)."""
    for d, entry in enumerate(spec or ()):
        if entry is not None:
            t = block(t, d, mesh, entry)
    return t


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a global ``shape`` under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec or ()):
        if entry is not None:
            out[d] //= axes_size(mesh, entry)
    return tuple(out)


def model_dim(spec) -> Optional[int]:
    """The dim ``spec`` shards over 'model', or None."""
    for d, entry in enumerate(spec or ()):
        if "model" in entry_axes(entry):
            return d
    return None


# ---------------------------------------------------------------------------
# placement on plain tensors (the model's and the train step's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a leaf's mesh and spec (``None``:
    replicated)."""
    mesh: Any
    spec: Any = None


def map_specs(fn, specs):
    """``fn(spec)`` at every leaf of a spec tree (a spec, a tuple
    subclass, is a leaf; so is ``None``)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list) or (isinstance(specs, tuple)
                                   and not isinstance(specs, P)):
        return type(specs)(map_specs(fn, v) for v in specs)
    return fn(specs)


def to_named(specs, mesh):
    """PartitionSpec tree -> :class:`NamedSharding` tree (``None`` ->
    replicated), for ``CheckpointManager.restore(shardings=)``."""
    return map_specs(lambda s: NamedSharding(mesh, s), specs)


def _per_leaf(fn, tree, specs):
    """``fn(leaf, spec)`` at every leaf of ``tree`` (``None`` stays)."""
    return unflatten_as(tree, [
        None if t is None else fn(t, s) for t, s in
        zip(flatten_up_to(tree, tree), flatten_up_to(tree, specs))])


def place(tree, specs, mesh):
    """Each rank's local shard of every leaf of ``tree`` (whole tensors)
    per ``specs``, as a plain tensor: a contiguous copy of the block
    (:func:`local_shard`), so the whole leaf can be freed; a leaf whose
    block is the whole of it (replicated, or over axes of size 1) is
    returned as it is."""
    def one(t, spec):
        if axes_size(mesh, spec_axes(spec)) == 1:
            return t
        return local_shard(t, spec, mesh).clone(
            memory_format=torch.contiguous_format)
    return _per_leaf(one, tree, specs)


def unplace(tree, specs, mesh):
    """The inverse of :func:`place`: every sharded leaf all-gathered over
    its spec's axes (every rank gets the whole tensor; no gradient)."""
    def one(t, spec):
        for d, entry in enumerate(spec or ()):
            if entry is not None:
                t = all_gather_cat(t, d, mesh, entry_axes(entry))
        return t
    return _per_leaf(one, tree, specs)


@dataclasses.dataclass(frozen=True)
class Placed:
    """A ``DeviceMesh`` whose params are placed (:func:`place`) per
    ``specs``: what the model functions and the train step take as
    ``mesh`` for placed params.

    ``local_rows``: the activations' rows are already this rank's (the
    train step's micro-batches); otherwise every rank passes the same
    global batch and only the MoE bodies split it, as under a plain
    mesh. Gradients through a placed model are taken only with local
    rows: the FSDP gathers' backward sums over the data ranks' rows."""
    mesh: Any
    specs: Any
    local_rows: bool = False

    def sub(self, key) -> "Placed":
        """The same placement for the subtree ``key`` of the specs."""
        return Placed(self.mesh, self.specs[key], self.local_rows)

    def spec(self, key):
        """The spec of leaf (or CUR / adapter dict) ``key``; ``None`` when
        the tree has no entry for it."""
        if isinstance(self.specs, dict):
            return self.specs.get(key)
        return None


def _spec_of(entries):
    """A spec of ``entries``, or None when none shards its dim."""
    return P(*entries) if any(e is not None for e in entries) else None


def drop_lead(spec):
    """The spec of one repeat of a stacked leaf (its leading ``repeats``
    dim is never sharded)."""
    return None if spec is None else _spec_of(tuple(spec)[1:])


def state_specs(params, specs, opt_state):
    """The spec tree of an AdamW state from its params' specs: moments
    take the param's spec, int8 row scales the param's minus its last
    dim (``state_spec_from_param``), the step count none. Placed or whole
    trees alike (the shapes are not read)."""
    def key_spec(spec, key):
        return _spec_of(state_spec_from_param(tuple(spec or ()), key))

    flat = [None if mom is None else {k: key_spec(spec, k) for k in mom}
            for spec, mom in zip(flatten_up_to(params, specs),
                                 flatten_up_to(params, opt_state["moments"]))]
    return {"step": None, "moments": unflatten_as(params, flat)}
