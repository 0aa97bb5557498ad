"""numpy <-> torch for parameter trees, and the tree walks the port shares.

The trees have the JAX package's layout (``repro.models.model.init_params``):
a dict with ``embed`` / ``out_head`` / ``final_norm`` and a ``groups`` list
of per-pattern lists of block dicts whose leaves carry a leading
``repeats`` axis. A CUR weight is a dict ``{C, U0, dU, R}`` (healing form)
or ``{CU, R}`` (folded form); it converts like any other subtree. ``None``
is an empty subtree, as in ``jax.tree``: the frozen leaves of a healing
optimizer state are ``None`` and cross as ``None``.

bf16 leaves cross as float32 numpy arrays (numpy has no bfloat16) and are
cast back on the other side, which is exact in both directions.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

NP_TO_TORCH = {  # numpy dtype name -> torch dtype (ml_dtypes bfloat16)
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int32": torch.int32, "int64": torch.int64,
    "bool": torch.bool,
}


def to_torch(tree: Any, device) -> Any:
    """Numpy-leaved tree (e.g. ``jax.device_get(params)`` or arrays that
    expose ``__array__``) -> torch tree on ``device``. A leaf whose dtype
    is named ``bfloat16`` (ml_dtypes) becomes ``torch.bfloat16``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    name = str(getattr(tree, "dtype", np.asarray(tree).dtype))
    arr = np.asarray(tree)
    dt = NP_TO_TORCH.get(name)
    if dt is None:
        raise TypeError(f"bridge: unsupported leaf dtype {name}")
    if dt == torch.bfloat16:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(
        device=device, dtype=dt)


def to_numpy(tree: Any) -> Any:
    """Torch tree -> numpy tree. bf16 leaves come back as float32 arrays
    (exact)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf (dicts and lists are structure,
    ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def flatten_up_to(template: Any, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``template``, in
    ``jax.tree.leaves`` order (dict keys sorted). A ``None`` in
    ``template`` counts as a leaf, as with JAX's ``is_leaf=lambda x: x is
    None``; so ``flatten_up_to(params, opt_moments)`` gives one moment
    dict (or ``None``) per parameter."""
    if isinstance(template, dict):
        return [x for k in sorted(template)
                for x in flatten_up_to(template[k], tree[k])]
    if isinstance(template, (list, tuple)):
        return [x for t, s in zip(template, tree)
                for x in flatten_up_to(t, s)]
    return [tree]


def unflatten_as(template: Any, leaves) -> Any:
    """Inverse of :func:`flatten_up_to`: the structure of ``template``
    with its leaf positions (``None`` included) filled from ``leaves``."""
    return _build(template, iter(leaves))


def _build(t, it):
    # a module-level function, not a recursive closure: a closure that
    # calls itself is a reference cycle, and one holding the leaves'
    # iterator keeps every leaf (views of whole models) alive until the
    # garbage collector next runs
    if isinstance(t, dict):
        out = {k: _build(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)
