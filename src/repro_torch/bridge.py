"""numpy <-> torch for parameter trees.

The trees have the JAX package's layout (``repro.models.model.init_params``):
a dict with ``embed`` / ``out_head`` / ``final_norm`` and a ``groups`` list
of per-pattern lists of block dicts whose leaves carry a leading
``repeats`` axis. A CUR weight is a dict ``{C, U0, dU, R}`` (healing form)
or ``{CU, R}`` (folded form); it converts like any other subtree.

bf16 leaves cross as float32 numpy arrays (numpy has no bfloat16) and are
cast back on the other side, which is exact in both directions.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

_NP_TO_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def to_torch(tree: Any, device) -> Any:
    """Numpy-leaved tree (e.g. ``jax.device_get(params)`` or arrays that
    expose ``__array__``) -> torch tree on ``device``. A leaf whose dtype
    is named ``bfloat16`` (ml_dtypes) becomes ``torch.bfloat16``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    name = str(getattr(tree, "dtype", np.asarray(tree).dtype))
    arr = np.asarray(tree)
    dt = _NP_TO_TORCH.get(name)
    if dt is None:
        raise TypeError(f"bridge: unsupported leaf dtype {name}")
    if dt == torch.bfloat16:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(
        device=device, dtype=dt)


def to_numpy(tree: Any) -> Any:
    """Torch tree -> numpy tree. bf16 leaves come back as float32 arrays
    (exact)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf (dicts and lists are structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)

