"""Fault-tolerant checkpointing, on the JAX package's on-disk format
(``repro.dist.checkpoint``): a checkpoint written by either package
restores in the other.

Layout: one directory per step under the manager root,

    step_00000123/
        leaf_00000.npy ... leaf_NNNNN.npy     flattened tree leaves
        manifest.json                         step, leaf files, crc32s

Leaves are numbered in ``jax.tree.leaves`` order (:func:`tree_flatten`):
dict keys sorted, lists and tuples in order, ``None`` an empty subtree.

Guarantees:
  - **Atomicity**: leaves + manifest are written into ``step_*.tmp`` and
    ``os.replace``d into place; a crash mid-save leaves only a ``.tmp``
    directory, which is never listed as a checkpoint (and is swept by the
    next save).
  - **Corruption fallback**: every leaf file carries a crc32 in the
    manifest; ``latest_valid_step`` verifies and falls back to the newest
    step whose files all check out.
  - **Keep-N GC**: after a successful save, all but the newest ``keep_n``
    steps are deleted.
  - **Async save**: ``save(..., blocking=False)`` copies the leaves to host
    memory synchronously (so the caller can overwrite its tensors) and
    writes on a background thread; ``wait()`` joins it.

bfloat16 leaves are stored as uint16 views of their bits (npy has no
portable bf16 descr); the manifest records the logical dtype for restore.
Each leaf's crc32 is computed over the bytes as they are written (the same
value as re-reading the file, without the second pass).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import NP_TO_TORCH, flatten_up_to

_STEP_RE = re.compile(r"^step_(\d{8})$")
_BF16_TAG = "bfloat16"
_TORCH_TO_TAG = {v: k for k, v in NP_TO_TORCH.items()}


def step_dirname(step: int) -> str:
    return f"step_{step:08d}"


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


class _Crc32Writer:
    """A write-only file wrapper that keeps the crc32 of what passed."""

    def __init__(self, f):
        self.f, self.crc = f, 0

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc)
        return self.f.write(b)


# ---------------------------------------------------------------------------
# trees (the jax.tree.leaves order)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A restore-template leaf: the shape and dtype of a tensor (the JAX
    package uses ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def tree_flatten(tree) -> List[Any]:
    """Leaves of a tree of dicts / lists / tuples in ``jax.tree.leaves``
    order: dict keys sorted, sequences in order, ``None`` no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """The structure of ``template`` with its leaves replaced, in
    :func:`tree_flatten` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def _dtype_tag(dtype: torch.dtype) -> str:
    try:
        return _TORCH_TO_TAG[dtype]
    except KeyError:
        raise TypeError(f"checkpoint: unsupported leaf dtype {dtype}")


def tree_template(tree) -> Any:
    """JSON-able structural description of a tree (nested dict / list /
    tuple containers, tensor leaves as shape + dtype), in the JAX
    package's format. Paired with :func:`template_from`, it lets a consumer
    ``restore`` a checkpoint without re-deriving the producing
    computation's output structure (e.g. a CURed tree whose per-weight
    {CU, R} shapes depend on the compression)."""
    if tree is None:
        return {"kind": "none"}
    if isinstance(tree, dict):
        return {"kind": "dict",
                "items": {str(k): tree_template(v)
                          for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"kind": "list" if isinstance(tree, list) else "tuple",
                "items": [tree_template(v) for v in tree]}
    return {"kind": "leaf", "shape": [int(s) for s in tree.shape],
            "dtype": _dtype_tag(tree.dtype)}


def template_from(desc) -> Any:
    """Inverse of :func:`tree_template`: a tree of :class:`TensorSpec`
    usable as a ``CheckpointManager.restore`` template."""
    kind = desc["kind"]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: template_from(v) for k, v in desc["items"].items()}
    if kind in ("list", "tuple"):
        items = [template_from(v) for v in desc["items"]]
        return items if kind == "list" else tuple(items)
    return TensorSpec(tuple(desc["shape"]), NP_TO_TORCH[desc["dtype"]])


def save_tree_template(path: str, tree) -> None:
    """Write ``tree_template(tree)`` as JSON next to a checkpoint dir."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(tree_template(tree), f)


def load_tree_template(path: str) -> Any:
    with open(path) as f:
        return template_from(json.load(f))


# ---------------------------------------------------------------------------
# leaves <-> host arrays
# ---------------------------------------------------------------------------

def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """Tensor -> (a host copy as a C-ordered ndarray, logical dtype tag).
    The copy is made even for a CPU tensor, so an async save never reads
    memory the caller may overwrite."""
    t = leaf.detach().contiguous()
    tag = _dtype_tag(t.dtype)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.to("cpu", copy=True).numpy()
    return (arr.view(np.uint16) if tag == _BF16_TAG else arr), tag


def _from_host(arr: np.ndarray, dtype_tag: str, device) -> torch.Tensor:
    if dtype_tag == _BF16_TAG:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    """Manages the checkpoint directory for one run."""

    def __init__(self, directory: str, keep_n: Optional[int] = None,
                 retries: int = 0, backoff_s: float = 0.05):
        self.directory = directory
        self.keep_n = keep_n
        self.retries = retries
        self.backoff_s = backoff_s
        #: test/chaos hook: called with the attempt index at the start of
        #: every write attempt; raising OSError simulates transient IO
        self.fault_hook: Optional[Callable[[int], None]] = None
        self._thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- enumeration --------------------------------------------------------

    def all_steps(self):
        """Steps with a completed (renamed + manifest) checkpoint dir."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if not m:
                continue
            if os.path.isfile(os.path.join(self.directory, name,
                                           "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _verify(self, step: int) -> bool:
        d = os.path.join(self.directory, step_dirname(step))
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            for entry in manifest["leaves"]:
                path = os.path.join(d, entry["file"])
                if _crc32_file(path) != entry["crc32"]:
                    return False
        except (OSError, ValueError, KeyError):
            return False
        return True

    def latest_valid_step(self) -> Optional[int]:
        """Newest step whose leaf checksums all verify (corruption skips
        back to the previous intact checkpoint)."""
        for step in reversed(self.all_steps()):
            if self._verify(step):
                return step
        return None

    def leaf_count(self, step: int) -> int:
        """Number of tree leaves in checkpoint ``step`` (manifest read
        only)."""
        d = os.path.join(self.directory, step_dirname(step))
        with open(os.path.join(d, "manifest.json")) as f:
            return int(json.load(f)["n_leaves"])

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Write ``tree`` as checkpoint ``step``. With ``blocking=False``
        the device->host copy happens now and the file I/O on a
        background thread."""
        self.wait()                      # one in-flight async save at a time
        host = [_to_host(leaf) for leaf in tree_flatten(tree)]
        if blocking:
            self._write_retrying(step, host)
            return
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host), daemon=True)
        self._thread.start()

    def _write_guarded(self, step, host):
        try:
            self._write_retrying(step, host)
        except BaseException as e:  # surfaced by the next wait()/save()
            self._save_error = e

    def _write_retrying(self, step, host) -> None:
        """``_write`` with up to ``retries`` extra attempts on transient
        OSError, backed off exponentially (``backoff_s * 2**attempt``).
        The final failure propagates: immediately for a blocking save,
        on the next ``wait()``/``save()`` for an async one."""
        for attempt in range(self.retries + 1):
            try:
                if self.fault_hook is not None:
                    self.fault_hook(attempt)
                self._write(step, host)
                return
            except OSError:
                if attempt >= self.retries:
                    raise
                time.sleep(self.backoff_s * (2 ** attempt))

    def _write(self, step: int, host) -> None:
        final = os.path.join(self.directory, step_dirname(step))
        tmp = final + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries = []
        for i, (arr, dtype_tag) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                w = _Crc32Writer(f)
                np.save(w, arr)
            entries.append({"file": fname, "dtype": dtype_tag,
                            "crc32": w.crc & 0xFFFFFFFF})
        manifest = {"step": step, "n_leaves": len(entries),
                    "leaves": entries}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        # dead .tmp dirs from crashed saves
        for name in os.listdir(self.directory):
            if name.endswith(".tmp") and _STEP_RE.match(name[:-4]):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        if not self.keep_n:
            return
        steps = self.all_steps()
        for step in steps[:-self.keep_n]:
            shutil.rmtree(
                os.path.join(self.directory, step_dirname(step)),
                ignore_errors=True)

    def wait(self) -> None:
        """Join any in-flight async save; re-raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise err

    # -- restore ------------------------------------------------------------

    def restore(self, template: Any, shardings: Any = None,
                step: Optional[int] = None,
                device=None) -> Tuple[int, Any]:
        """Load the newest valid checkpoint (or ``step``) into the
        structure of ``template`` (whole tensors or :class:`TensorSpec`
        leaves). Returns (step, tree).

        ``shardings``: a tree of ``NamedSharding`` (mesh, spec) leaves
        (``repro_torch.dist.sharding.to_named``) matching ``template``:
        each leaf is read memory-mapped and only this rank's block is
        copied out and moved to the mesh's device, so no rank holds a
        whole sharded leaf. Without it every leaf is placed whole on
        ``device`` (``"cuda"`` unless the caller asks for the CPU)."""
        if step is None:
            step = self.latest_valid_step()
        if step is None:
            raise FileNotFoundError(
                f"no valid checkpoint under {self.directory}")
        d = os.path.join(self.directory, step_dirname(step))
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = tree_flatten(template)
        if len(flat) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint {step} has {manifest['n_leaves']} leaves, "
                f"template has {len(flat)}")
        if shardings is None:
            device = resolve_device(device)
            sh_flat = [None] * len(flat)
        else:
            sh_flat = [s for t, s in zip(flatten_up_to(template, template),
                                         flatten_up_to(template, shardings))
                       if t is not None]
        out = []
        for i, (entry, tmpl, sh) in enumerate(zip(manifest["leaves"], flat,
                                                  sh_flat)):
            arr = np.load(os.path.join(d, entry["file"]),
                          mmap_mode=None if sh is None else "r")
            tshape = getattr(tmpl, "shape", None)
            if tshape is not None and tuple(arr.shape) != tuple(tshape):
                raise ValueError(
                    f"checkpoint {step} leaf {i} ({entry['file']}) has "
                    f"shape {tuple(arr.shape)}, template expects "
                    f"{tuple(tshape)}: wrong arch/config for this "
                    f"checkpoint dir?")
            if sh is None:
                out.append(_from_host(arr, entry["dtype"], device))
            else:
                # a copy of this rank's block only (not a view of the map)
                out.append(_from_host(
                    np.array(arr[_block_index(arr.shape, sh)]),
                    entry["dtype"], resolve_device(sh.mesh.device_type)))
        return step, tree_unflatten(template, out)


def _block_index(shape, sharding):
    """This rank's slices of a leaf of ``shape`` under a NamedSharding."""
    from repro_torch.dist.collectives import axes_index, axes_size
    index = []
    for d, entry in enumerate(sharding.spec or ()):
        if entry is None:
            index.append(slice(None))
            continue
        n = axes_size(sharding.mesh, entry)
        step = shape[d] // n
        lo = axes_index(sharding.mesh, entry) * step
        index.append(slice(lo, lo + step))
    return tuple(index)
