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
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_sizes


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
    for a in reversed(entry_axes(axes)):           # minor axis first
        g = mesh.get_group(a)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x.contiguous(), group=g)
        x = torch.cat(parts, dim=dim)
    return x


def all_reduce(x, mesh, axes):
    """In-place sum of ``x`` over ``axes`` (no gradient)."""
    for a in entry_axes(axes):
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


def all_reduce_max(x, mesh, axes):
    """In-place maximum of ``x`` over ``axes`` (no gradient)."""
    for a in entry_axes(axes):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return x


def reduce_scatter(x, dim: int, mesh, axes):
    """This rank's block along ``dim`` of the sum of ``x`` over ``axes``
    (no gradient): the all-reduce's sum, of which each rank keeps the
    block it owns."""
    for a in entry_axes(axes):                     # major axis first
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
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
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
