"""Sensitivity profiling: per-weight error-vs-rank curves in ONE pass.

For every compressible target weight the profiler produces the relative
Frobenius error ``||W - C U R||_F / ||W||_F`` and the Theorem 3.1
spectral bound at every rank of a geometric grid — WITHOUT recompressing
per rank. Two structural facts make that possible:

  1. the selection SVD at the top grid rank contains the leading singular
     vectors of every smaller rank, and
  2. DEIM is prefix-consistent: step ``j`` of the greedy loop only reads
     columns ``<= j`` of the singular-vector block, so
     ``deim(P[:, :r]) == deim(P[:, :r_hi])[:r]`` exactly.

So one SVD + one DEIM sweep at ``r_hi`` yields the *same* row/col
selections ``compress_model`` would make at each grid rank, and the per
rank work collapses to the pinv link solves. Weights are grouped by
(m, n) shape-class and each class runs as one batched call on the
weights' device (in chunks of at most ``CHUNK_BYTES`` of f32 weights)
with a single host transfer per chunk.

The selection identity is exact for ``svd="exact"``. Under
``svd="randomized"`` the executed compression re-sketches at each
assigned rank with a test matrix of another width (drawn from the same
per-weight seed), so the curves are estimates rather than the realized
errors — plan with exact SVD when prediction fidelity matters.

Only the DEIM-based selections (``wanda_deim``, ``deim``) are
profile-able this way; the other ablation strategies raise.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CURConfig, ModelConfig
from repro_torch.core import angular
from repro_torch.core.calibrate import CalibStats
from repro_torch.core.compress import _cur_work_list, rank_key, sketch_matrices
from repro_torch.core.cur import (
    exact_svd, pinv, randomized_svd, spectral_error_bound, take_cols,
    take_rows)
from repro_torch.core.deim import deim
from repro_torch.core.wanda import wanda_scores

_PROFILE_SELECTIONS = ("wanda_deim", "deim")

# f32 weight bytes one batched call of a shape-class may take; a larger
# class runs in chunks (the curves of a weight do not depend on its chunk)
CHUNK_BYTES = 4 << 30


# ---------------------------------------------------------------------------
# provenance hashes
# ---------------------------------------------------------------------------

def config_hash(cfg: ModelConfig) -> str:
    """Stable digest of the model config a plan was computed against."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def calib_hash(calib: CalibStats) -> str:
    """Digest of the calibration statistics (hidden states + WANDA
    activations + token count) — two runs over the same data agree."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(calib.hidden, np.float32).tobytes())
    for layer in calib.act_sq or []:
        for name in sorted(layer):
            h.update(name.encode())
            h.update(np.ascontiguousarray(layer[name], np.float32).tobytes())
    h.update(str(calib.n_tokens).encode())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# curves
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WeightCurve:
    """Error-vs-rank curve of one weight. ``grid`` is ascending; entries
    beyond the weight's feasible range (Eq. 2 or min(m, n)) are omitted."""
    layer: int
    name: str
    shape: Tuple[int, int]
    grid: Tuple[int, ...]
    rel_err: np.ndarray          # (len(grid),) ||W - CUR_r||_F / ||W||_F
    # activation-weighted (functional) relative error:
    # ||diag(sqrt(act_sq)) (W - CUR_r)||_F / ||diag(sqrt(act_sq)) W||_F,
    # the allocator's default objective (tracks the layer's output
    # distortion under the diagonal input-covariance approximation)
    func_err: np.ndarray
    bound: np.ndarray            # Theorem 3.1 bound per rank (see bound_on)
    bound_on: str
    fro_w: float                 # ||W||_F
    func_fro_w: float            # ||diag(sqrt(act_sq)) W||_F

    @property
    def key(self) -> str:
        return rank_key(self.layer, self.name)


@dataclasses.dataclass
class SensitivityProfile:
    curves: List[WeightCurve]
    grid: Tuple[int, ...]
    selection: str
    svd: str
    seconds: float
    cfg_hash: str
    calib_hash: str
    distances: np.ndarray        # angular layer distances (for layer choice)
    # wall seconds per "MxN" shape-class, each ending at its host transfer
    class_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def curve(self, key: str) -> WeightCurve:
        for c in self.curves:
            if c.key == key:
                return c
        raise KeyError(key)

    def to_jsonable(self) -> dict:
        return {
            "grid": list(self.grid),
            "selection": self.selection,
            "svd": self.svd,
            "seconds": round(self.seconds, 4),
            "cfg_hash": self.cfg_hash,
            "calib_hash": self.calib_hash,
            "curves": [{
                "key": c.key, "shape": list(c.shape),
                "grid": list(c.grid),
                "rel_err": [round(float(e), 6) for e in c.rel_err],
                "func_err": [round(float(e), 6) for e in c.func_err],
                "bound": [None if not np.isfinite(b) else round(float(b), 4)
                          for b in c.bound],
                "bound_on": c.bound_on,
            } for c in self.curves],
        }


def default_grid(r_max: int = 256, r_min: int = 4) -> Tuple[int, ...]:
    """Geometric (power-of-two) rank grid, matching Eq. 2's quantization."""
    grid, r = [], r_min
    while r <= r_max:
        grid.append(r)
        r *= 2
    return tuple(grid)


def feasible_grid(m: int, n: int, grid: Sequence[int]) -> Tuple[int, ...]:
    """Grid entries that still SAVE parameters in the healing (unfolded)
    form — m r + r^2 + r n < m n — and fit min(m, n). Using the stricter
    unfolded test keeps every profiled rank deployable under either form
    (``compress_model``'s Eq. 2 guard never drops a planned weight)."""
    return tuple(r for r in sorted(set(int(g) for g in grid))
                 if r <= min(m, n) and m * r + r * r + r * n < m * n)


@torch.no_grad()
def _profile_class(Ws, acts, seeds, *, grid: Tuple[int, ...],
                   selection: str, svd: str) -> torch.Tensor:
    """One shape-class: Ws (k, m, n), acts (k, m), one item seed per
    weight. Returns (k, 3 len(grid) + 2) f32 on the device: rel_err,
    func_err and bound per grid rank, then ||W||_F and the weighted norm."""
    r_hi = grid[-1]
    m, n = Ws.shape[-2:]
    Wf = Ws.float()
    S = wanda_scores(Ws, acts) if selection == "wanda_deim" else Wf
    k = min(r_hi + 1, min(m, n))
    if svd == "exact":
        P, sig, Q = exact_svd(S, k)
    else:
        P, sig, Q = randomized_svd(S, k, G=sketch_matrices(
            seeds, n, min(k + 8, min(m, n)), Ws.device))
    p_hi, q_hi = deim(P[..., :r_hi]), deim(Q[..., :r_hi])
    sa = torch.sqrt(torch.clamp(acts.float(), min=0.0))[..., :, None]
    fro_w = torch.linalg.norm(Wf, dim=(-2, -1))
    func_w = torch.linalg.norm(sa * Wf, dim=(-2, -1))
    errs, ferrs, bounds = [], [], []
    for r in grid:
        p, q = p_hi[..., :r], q_hi[..., :r]
        C, R = take_cols(Wf, q), take_rows(Wf, p)
        U = (pinv(C) @ Wf) @ pinv(R)
        D = Wf - C @ U @ R
        errs.append(torch.linalg.norm(D, dim=(-2, -1))
                    / torch.clamp(fro_w, min=1e-30))
        ferrs.append(torch.linalg.norm(sa * D, dim=(-2, -1))
                     / torch.clamp(func_w, min=1e-30))
        # inf where the SVD has no sigma_{r+1} (r = min(m, n))
        bounds.append(spectral_error_bound(P[..., :r], Q[..., :r], sig, p, q))
    return torch.stack(errs + ferrs + bounds + [fro_w, func_w], dim=-1)


def profile_sensitivity(params, cfg: ModelConfig, cur_cfg: CURConfig,
                        calib: CalibStats,
                        grid: Optional[Sequence[int]] = None,
                        layers: Optional[Sequence[int]] = None,
                        ) -> SensitivityProfile:
    """Error-vs-rank curves for every compressible target weight of
    ``layers`` (default: every interior layer, first/last excluded like
    the paper's layer rule). One batched call per (m, n) class chunk, on
    the weights' device."""
    if cur_cfg.selection not in _PROFILE_SELECTIONS:
        raise ValueError(
            f"sensitivity profiling needs a DEIM-based selection "
            f"{_PROFILE_SELECTIONS}, got {cur_cfg.selection!r}")
    t0 = time.perf_counter()
    if grid is None:
        grid = default_grid(cur_cfg.r_max)
    if layers is None:
        layers = range(1, cfg.n_layers - 1)
    # a plan's ranks are per weight name: held experts (one name a stack)
    # are not planned
    work = [it for it in _cur_work_list(params, cfg, cur_cfg, calib,
                                        set(layers)) if it.expert is None]

    classes: Dict[Tuple[int, int], List[int]] = {}
    for i, it in enumerate(work):
        classes.setdefault(tuple(it.W.shape), []).append(i)

    bound_on = "wanda" if cur_cfg.selection == "wanda_deim" else "weight"
    curves: List[Optional[WeightCurve]] = [None] * len(work)
    class_seconds: Dict[str, float] = {}
    for (m, n), idxs in classes.items():
        cls_grid = feasible_grid(m, n, grid)
        if not cls_grid:
            continue                             # nothing saves params here
        t_cls = time.perf_counter()
        g = len(cls_grid)
        chunk = max(1, CHUNK_BYTES // (4 * m * n))
        for c0 in range(0, len(idxs), chunk):
            part = idxs[c0:c0 + chunk]
            Ws = torch.stack([work[i].W for i in part])
            dev = Ws.device
            # unit weights when a target has no calibration stats (possible
            # under plain "deim" selection): func_err degrades to rel_err
            acts = torch.stack([
                torch.as_tensor(work[i].act, dtype=torch.float32, device=dev)
                if work[i].act is not None
                else torch.ones((m,), dtype=torch.float32, device=dev)
                for i in part])
            out = _profile_class(
                Ws, acts, [work[i].seed for i in part], grid=cls_grid,
                selection=cur_cfg.selection, svd=cur_cfg.svd)
            out = out.cpu().numpy().astype(np.float64)   # one transfer
            del Ws, acts
            for k, i in enumerate(part):
                it = work[i]
                curves[i] = WeightCurve(
                    layer=it.layer, name=it.name, shape=(m, n),
                    grid=cls_grid, rel_err=out[k, :g],
                    func_err=out[k, g:2 * g], bound=out[k, 2 * g:3 * g],
                    bound_on=bound_on, fro_w=float(out[k, 3 * g]),
                    func_fro_w=float(out[k, 3 * g + 1]))
        class_seconds[f"{m}x{n}"] = time.perf_counter() - t_cls

    return SensitivityProfile(
        curves=[c for c in curves if c is not None],
        grid=tuple(int(g) for g in grid),
        selection=cur_cfg.selection, svd=cur_cfg.svd,
        seconds=time.perf_counter() - t0,
        cfg_hash=config_hash(cfg), calib_hash=calib_hash(calib),
        distances=angular.layer_distances(calib.hidden),
        class_seconds=class_seconds)
