"""Compressed gradient collectives with error feedback
(``repro.dist.compression`` in the JAX package).

Gradients are quantized per row (last-dim absmax, int8 codes + one f32
scale per row): the same format as the optimizer's 8-bit moments
(``repro_torch.optim.adamw``), so the wire payload is 1 byte/element +
4 bytes/row, ~3.9x fewer bytes than dense f32.

``compressed_psum`` replaces a sum over mesh axes: each rank quantizes
its tensor, the int8 codes + scales are all-gathered over the axes'
groups (the compressed payload is what crosses the interconnect), and the
reduction happens locally in f32. ``ef_psum_grads`` is the mesh train
step's error-feedback reduction through it; on placed gradients (each
rank's shards) a leaf's residual is shaped like its shard, a row whose
last dim is sharded takes its scale as the max over that dim's ranks,
and a leaf sharded over a batch axis (FSDP: its gradient was already
summed over it) is reduced over the other batch axes only.

``ef_compress_grads`` implements error feedback (EF-SGD): the previous
round's quantization residual is added to the gradient before
compressing, so the compressor's bias cancels over steps.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.bridge import flatten_up_to, tree_map, unflatten_as
from repro_torch.dist.collectives import all_gather_stack, spec_axes
# one quantizer: the gradient wire format IS the optimizer's moment format
from repro_torch.optim.adamw import dq8_rowwise as _dq8
from repro_torch.optim.adamw import q8_rowwise as _q8
from repro_torch.optim.adamw import sharded_rowmax


@torch.no_grad()
def compressed_psum(x, mesh, axes):
    """int8-compressed all-reduce of ``x`` over the mesh ``axes`` (an axis
    name or a tuple of them), in ``x``'s dtype.

    Semantics match a sum over the axes up to quantization error (bounded
    by n_ranks * rowmax / 254). Wire payload per rank: 1 byte/element +
    4 bytes/row, vs 4 bytes/element dense."""
    return _sum_codes(*_q8(x), mesh, axes).to(x.dtype)


def _sum_codes(q, scale, mesh, axes):
    """f32 sum over the axes of every rank's dequantized codes."""
    qg = all_gather_stack(q, mesh, axes)           # (n, ...) int8
    sg = all_gather_stack(scale, mesh, axes)       # (n, ...) f32
    return torch.sum(_dq8(qg, sg), dim=0)


def wire_bytes(shape, dtype=torch.float32, compressed: bool = False) -> int:
    """Per-device payload bytes for one all-reduce of ``shape``, dense or
    compressed."""
    n_elems = 1
    for d in shape:
        n_elems *= int(d)
    rows = n_elems // int(shape[-1]) if shape else 1
    if compressed:
        return n_elems + 4 * rows                  # int8 codes + f32 scales
    return n_elems * dtype.itemsize


def init_residuals(grads: Any) -> Any:
    """Zero error-feedback residuals (f32) mirroring the gradient tree, on
    each leaf's device (a ``meta`` tree gives shapes only)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


@torch.no_grad()
def ef_compress_grads(grads: Any, residuals: Any) -> Tuple[Any, Any]:
    """Error-feedback compression of a gradient tree.

    Returns ``(compressed, new_residuals)``: the dequantized (wire-format)
    gradient and the quantization error carried into the next step,

        comp_t = Q(g_t + r_{t-1});  r_t = g_t + r_{t-1} - comp_t
    """
    def one(g, r):
        comp = g.to(torch.float32) + r
        deq = _dq8(*_q8(comp))
        return deq.to(g.dtype), comp - deq

    return _map2(one, grads, residuals)


def _map2(one, grads, residuals):
    flat_g = flatten_up_to(grads, grads)
    flat_r = flatten_up_to(grads, residuals)
    out = [one(g, r) for g, r in zip(flat_g, flat_r)]
    return (unflatten_as(grads, [o[0] for o in out]),
            unflatten_as(grads, [o[1] for o in out]))


@torch.no_grad()
def ef_psum_grads(grads: Any, residuals: Any, mesh, axes,
                  specs: Any = None) -> Tuple[Any, Any]:
    """Error-feedback reduction of this rank's gradient tree over the mesh
    ``axes``: the sum over the ranks of their wire-format gradients, and
    this rank's new residuals,

        comp_i = g_i + r_i;  sum = sum_i dq(q(comp_i));
        r_i' = comp_i - dq(q(comp_i))

    Only codes and scales cross the interconnect (``compressed_psum``'s
    all-gather); each rank keeps its own residuals. On one rank this is
    :func:`ef_compress_grads`, bit for bit. ``specs`` (the params' spec
    tree) marks the gradients as placed shards (see the module
    docstring)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    flat_g = flatten_up_to(grads, grads)
    flat_s = (flatten_up_to(grads, specs) if specs is not None
              else [None] * len(flat_g))

    def one(g, r, spec):
        comp = g.to(torch.float32) + r
        q, scale = _q8(comp, rowmax=sharded_rowmax(mesh, spec))
        total = _sum_codes(q, scale, mesh, tuple(
            a for a in axes if a not in spec_axes(spec)))
        return total.to(g.dtype), comp - _dq8(q, scale)

    out = [None if g is None else one(g, r, s)
           for g, r, s in zip(flat_g, flatten_up_to(grads, residuals),
                              flat_s)]
    return (unflatten_as(grads, [o and o[0] for o in out]),
            unflatten_as(grads, [o and o[1] for o in out]))
