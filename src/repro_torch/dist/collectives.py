"""Collectives over named mesh axes, with the gradients a train step needs.

The JAX package runs its distributed bodies under ``shard_map``: each
device gets its block of the inputs, the body's collectives name mesh
axes, and the blocks of the output form one global array. The port keeps
that contract explicitly. A rank takes its block with :func:`scatter`,
runs the body with these collectives over the axis groups of a
``DeviceMesh``, and rebuilds the global tensor with :func:`gather`.

Each differentiable op is a Megatron-style ``autograd.Function`` whose
backward is the collective that its forward's transpose needs, given that
every rank of the group computes the same thing outside the body:

  scatter      forward: this rank's block;  backward: all-gather
  gather       forward: all-gather;         backward: this rank's block
  copy_to      forward: identity;           backward: all-reduce (sum)
  reduce_from  forward: all-reduce (sum);   backward: identity
  all_to_all   forward: all-to-all;         backward: all-to-all

(``torch.distributed.nn.functional.all_reduce`` all-reduces the incoming
gradient again in its backward, which multiplies a replicated gradient by
the group's size.) Two more serve placed weights and rank-local consumers,
where the cotangent differs from rank to rank:

  all_gather   forward: all-gather;         backward: reduce-scatter (sum)
  psum         forward: all-reduce (sum);   backward: all-reduce (sum)

``all_gather`` is the FSDP weight gather: each data rank's gradient of the
gathered weight comes from its own rows, so the backward sums them and
keeps this rank's block (``gather`` would keep only this rank's own
contribution). ``psum`` is a sum whose result every rank then uses in its
own way (a norm's statistics over a sharded feature dim). An op over
several axes (``("pod", "data")``) works major axis first, as a JAX
PartitionSpec entry does.

Every collective of the port goes through five funnels: ``all_gather_cat``,
``all_reduce``, ``all_reduce_max``, ``reduce_scatter`` and ``_a2a``. Inside
:func:`recording` each funnel call over a group of more than one rank notes
its operand's bytes under JAX's HLO opcode name (``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``; ``collective-permute``
stays 0: the port has none), with the call ``count`` and the ``total``, the
keys of ``repro.roofline.analysis.collective_bytes``. One call over several
axes counts once, as JAX's one collective over them does. Outside
:func:`recording` a funnel pays one call that checks ``None``. An axis of
one rank is skipped: a gather or an all-to-all over one rank returns a
copy, a sum leaves its operand as it is (``chip_smoke.py`` phase 12d
drives each NCCL call on the card all the same).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_sizes


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_RECORD: Optional[Dict[str, int]] = None


@contextlib.contextmanager
def recording():
    """Yields the dict the funnels note their operand bytes into (see the
    module docstring)."""
    global _RECORD
    prev = _RECORD
    _RECORD = dict.fromkeys(COLLECTIVES + ("count", "total"), 0)
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _note(op: str, x, moves) -> None:
    """Notes ``x``'s bytes under ``op`` when recording and the call
    ``moves`` (spans more than one rank)."""
    if _RECORD is None or not moves:
        return
    nbytes = x.numel() * x.element_size()
    _RECORD[op] += nbytes
    _RECORD["count"] += 1
    _RECORD["total"] += nbytes


def entry_axes(axes) -> Tuple[str, ...]:
    """The axis names of a spec entry (a name, a tuple of names, None)."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` shards a dim over, in dim order."""
    return tuple(a for e in (spec or ()) for a in entry_axes(e))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The batch axes on ``mesh``: those of ("pod", "data") it has."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _ranked(mesh, axes) -> Tuple[str, ...]:
    """The axes of ``axes`` with more than one rank (a collective over an
    axis of one rank moves nothing and is skipped)."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in entry_axes(axes) if sizes[a] > 1)


def axes_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in entry_axes(axes))


def axes_index(mesh, axes) -> int:
    """This rank's block index over ``axes`` (row-major, major first)."""
    sizes = axis_sizes(mesh)
    idx = 0
    for a in entry_axes(axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def block(x, dim: int, mesh, axes):
    """This rank's block of ``x`` along ``dim`` over ``axes`` (no
    gradient bookkeeping)."""
    n = axes_size(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways over {entry_axes(axes)}")
    step = x.shape[dim] // n
    return x.narrow(dim, axes_index(mesh, axes) * step, step)


def all_gather_cat(x, dim: int, mesh, axes):
    """Every rank's ``x`` over ``axes`` concatenated along ``dim`` in
    block order (no gradient)."""
    ranked = _ranked(mesh, axes)
    _note("all-gather", x, ranked)
    if not ranked:                                 # one rank: its own copy
        return x.clone(memory_format=torch.contiguous_format)
    for a in reversed(ranked):                     # minor axis first
        g = mesh.get_group(a)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x, group=g)
        x = torch.cat(parts, dim=dim)
    return x


def all_reduce(x, mesh, axes):
    """In-place sum of ``x`` over ``axes`` (no gradient)."""
    ranked = _ranked(mesh, axes)
    _note("all-reduce", x, ranked)
    for a in ranked:
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


def all_reduce_max(x, mesh, axes):
    """In-place maximum of ``x`` over ``axes`` (no gradient)."""
    ranked = _ranked(mesh, axes)
    _note("all-reduce", x, ranked)
    for a in ranked:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return x


def reduce_scatter(x, dim: int, mesh, axes):
    """This rank's block along ``dim`` of the sum of ``x`` over ``axes``
    (no gradient): the all-reduce's sum, of which each rank keeps the
    block it owns."""
    ranked = _ranked(mesh, axes)
    _note("reduce-scatter", x, ranked)
    for a in ranked:                               # major axis first
        g = mesh.get_group(a)
        n = dist.get_world_size(g)
        parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
        if len(parts) != n or x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split {n} ways over {a}")
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=g)
        x = out
    return x


def relayout(x, have, want, mesh, axis: str = "model"):
    """``x``, this rank's block over ``axis`` along dim ``have`` (None:
    whole), in the layout of this rank's block along dim ``want`` (None:
    whole): all-gathered along ``have``, then cut along ``want``."""
    if have == want:
        return x
    if have is not None:
        x = all_gather_cat(x, have, mesh, axis)
    if want is not None:
        x = block(x, want, mesh, axis)
    return x


def all_gather_stack(x, mesh, axes):
    """(n, *x.shape): every rank's ``x`` over ``axes``, stacked in block
    order (``lax.all_gather``; no gradient)."""
    return all_gather_cat(x[None], 0, mesh, axes)


def _copy(x):
    return x.clone(memory_format=torch.contiguous_format)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return block(x, dim, mesh, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, *ctx.args), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return all_gather_cat(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return block(g, *ctx.args).contiguous(), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_copy(g), *ctx.args), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(_copy(x), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return all_gather_cat(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, *ctx.args), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return all_reduce(_copy(x), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_copy(g), *ctx.args), None, None


def _a2a(x, group):
    n = dist.get_world_size(group)
    _note("all-to-all", x, n > 1)
    if n == 1:
        return x.clone(memory_format=torch.contiguous_format)
    x = x.contiguous()                             # and so its result
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def scatter(x, dim: int, mesh, axes: Sequence[str] | str):
    return _Scatter.apply(x, dim, mesh, entry_axes(axes))


def gather(x, dim: int, mesh, axes: Sequence[str] | str):
    return _Gather.apply(x, dim, mesh, entry_axes(axes))


def copy_to(x, mesh, axes: Sequence[str] | str):
    axes = entry_axes(axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def reduce_from(x, mesh, axes: Sequence[str] | str):
    return _ReduceFrom.apply(x, mesh, entry_axes(axes))


def all_gather(x, dim: int, mesh, axes: Sequence[str] | str):
    """The whole of ``x`` along ``dim`` over ``axes``, whose backward
    reduce-scatters (sums) the cotangent: the FSDP weight gather."""
    axes = entry_axes(axes)
    return _AllGather.apply(x, dim, mesh, axes) if axes else x


def psum(x, mesh, axes: Sequence[str] | str):
    """Sum of ``x`` over ``axes`` whose backward sums the cotangents too
    (``lax.psum`` of a value each rank consumes differently)."""
    axes = entry_axes(axes)
    return _Psum.apply(x, mesh, axes) if axes else x


def all_to_all(x, mesh, axis: str):
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: the i-th of n equal
    row blocks of ``x`` goes to rank i of the axis; block j of the result
    came from rank j."""
    return _AllToAll.apply(x, mesh.get_group(axis))
