"""The CURing compression pipeline (paper §4).

``compress_model``:
  1. angular-distance layer selection over the calibration hidden states
     (first/last layers excluded),
  2. per selected layer, per target weight: WANDA importance -> SVD
     (exact, or randomized) -> DEIM row/col indices -> C = W[:, q],
     R = W[p, :], U0 = C+ W R+, dU = 0,
  3. rebuild the model with per-layer (unrolled) groups so compressed and
     dense layers coexist.

Two pipelines (``CURConfig.pipeline``): ``"batched"`` stacks the weights of
one (m, n, r) shape-class and runs the whole chain once for the stack (the
JAX package's ``vmap`` written out as a batch dim: batched SVD, QR, DEIM
and pinv); ``"loop"`` is the per-weight reference. Each weight draws its
randomness from its own generator, seeded from ``CURConfig.seed`` and its
place in network order, so both pipelines make identical selections.

Selection strategies (paper App. D.2): ``wanda_deim`` (CURing) | ``wanda``
| ``deim`` | ``weight`` | ``random``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.configs.base import CURConfig, ModelConfig
from repro_torch.core import angular
from repro_torch.core.calibrate import CalibStats
from repro_torch.core.cur import (
    cur_from_indices, exact_svd, randomized_svd, rank_for,
    spectral_error_bound)
from repro_torch.core.deim import deim
from repro_torch.core.wanda import wanda_scores
from repro_torch.models.model import iter_layer_params


@dataclasses.dataclass
class WeightInfo:
    layer: int
    name: str
    shape: Tuple[int, int]
    rank: int
    rows: np.ndarray
    cols: np.ndarray
    fro_err: float          # ||W - CUR||_F
    fro_w: float            # ||W||_F
    bound: float            # Theorem 3.1 spectral bound (see bound_on)
    seconds: float
    params_before: int
    params_after: int       # the DEPLOYED form: folded iff cur_cfg.fold_u
    params_after_unfolded: int = 0  # m r + r^2 + r n   ({C, U0, dU, R})
    params_after_folded: int = 0    # m r + r n         ({CU, R})
    # which matrix the Theorem 3.1 bound is valid for: the WANDA
    # importance matrix S ("wanda"), the raw weight W ("weight"), or not
    # computed ("none")
    bound_on: str = "none"


@dataclasses.dataclass
class CompressInfo:
    distances: np.ndarray
    layers: List[int]
    weights: List[WeightInfo]
    seconds_total: float
    seconds_fold: float = 0.0   # portion spent folding C@U (fold_u only)

    @property
    def params_saved(self) -> int:
        """Savings of the deployed form (folded iff cur_cfg.fold_u)."""
        return sum(w.params_before - w.params_after for w in self.weights)

    @property
    def params_saved_unfolded(self) -> int:
        return sum(w.params_before - w.params_after_unfolded
                   for w in self.weights)

    @property
    def params_saved_folded(self) -> int:
        return sum(w.params_before - w.params_after_folded
                   for w in self.weights)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _top_k_indices(scores: torch.Tensor, r: int) -> torch.Tensor:
    return torch.sort(torch.topk(scores, r, dim=-1).indices, dim=-1).values


def select_indices(W: torch.Tensor, r: int, method: str, act_sq,
                   seed: Union[int, Sequence[int]] = 0,
                   svd_method: str = "exact",
                   G: Optional[torch.Tensor] = None):
    """Pick r row indices p and r column indices q of W.

    W is one weight (m, n) with ``seed`` an int, or a stack (k, m, n) with
    ``act_sq`` (k, m) and ``seed`` a list of k ints. ``seed`` feeds the
    randomized SVD's test matrix (unless ``G`` is given) and the
    ``random`` method."""
    batched = W.dim() == 3
    seeds = list(seed) if batched else [seed]
    dev = W.device

    def svd_fn(M, rr):
        if svd_method == "exact":
            return exact_svd(M, rr)
        g = G
        if g is None:
            k = min(rr + 8, min(M.shape[-2:]))
            g = torch.stack([
                torch.randn((M.shape[-1], k), generator=_generator(s, dev),
                            device=dev) for s in seeds])
            g = g if batched else g[0]
        return randomized_svd(M, rr, G=g)

    aux = {}
    k_svd = min(r + 1, min(W.shape[-2:]))
    if method == "wanda_deim":
        S = wanda_scores(W, torch.as_tensor(act_sq, device=dev))
        P, sig, Q = svd_fn(S, k_svd)
        p, q = deim(P[..., :r]), deim(Q[..., :r])
        aux = {"P": P, "Q": Q, "sig": sig}
    elif method == "wanda":
        S = wanda_scores(W, torch.as_tensor(act_sq, device=dev))
        p = _top_k_indices(torch.linalg.norm(S, dim=-1), r)
        q = _top_k_indices(torch.linalg.norm(S, dim=-2), r)
    elif method == "deim":
        P, sig, Q = svd_fn(W.float(), k_svd)
        p, q = deim(P[..., :r]), deim(Q[..., :r])
        aux = {"P": P, "Q": Q, "sig": sig}
    elif method == "weight":
        Wf = W.float()
        p = _top_k_indices(torch.linalg.norm(Wf, dim=-1), r)
        q = _top_k_indices(torch.linalg.norm(Wf, dim=-2), r)
    elif method == "random":
        m, n = W.shape[-2:]
        ps, qs = [], []
        for s in seeds:
            g = _generator(s, dev)
            ps.append(torch.randperm(m, generator=g, device=dev)[:r])
            qs.append(torch.randperm(n, generator=g, device=dev)[:r])
        p, q = torch.stack(ps), torch.stack(qs)
        if not batched:
            p, q = p[0], q[0]
    else:
        raise ValueError(method)
    return p, q, aux


def _bound_on(selection: str) -> str:
    return {"wanda_deim": "wanda", "deim": "weight"}.get(selection, "none")


def rank_key(layer: int, name: str) -> str:
    """The ``CURConfig.ranks`` key format."""
    return f"{layer}:{name}"


def resolve_rank(m: int, n: int, layer: int, name: str,
                 cur_cfg: CURConfig) -> int:
    """Per-weight rank: the ``cur_cfg.ranks`` override when present, else
    the uniform Eq. 2 cap."""
    if cur_cfg.ranks:
        r = cur_cfg.ranks.get(rank_key(layer, name))
        if r is not None:
            return int(r)
    return rank_for(m, n, cur_cfg.r_max)


def _validate_ranks(params, cfg: ModelConfig, cur_cfg: CURConfig,
                    layer_set) -> None:
    """Every override key must name a still-dense 2-D weight in the target
    set, lie in a selected layer, and carry a feasible rank."""
    if not cur_cfg.ranks:
        return
    valid: Dict[str, Tuple[int, int]] = {}
    for li, spec, lp in iter_layer_params(params, cfg):
        for t in cfg.cur_targets:
            W = lp.get(t)
            if W is None or isinstance(W, dict) or W.dim() != 2:
                continue
            valid[rank_key(li, t)] = tuple(W.shape)
    for k, r in cur_cfg.ranks.items():
        if k not in valid:
            raise ValueError(
                f"rank override {k!r} does not name a compressible target "
                f"weight (targets: {cfg.cur_targets})")
        m, n = valid[k]
        if not 1 <= int(r) <= min(m, n):
            raise ValueError(
                f"rank override {k!r}={r} outside [1, min{(m, n)}]")
        if int(k.split(":")[0]) not in layer_set:
            raise ValueError(
                f"rank override {k!r} targets a layer not being compressed "
                f"(selected: {sorted(layer_set)})")


def _param_counts(m: int, n: int, r: int, fold_u: bool):
    """(before, after_unfolded, after_folded, after_deployed)."""
    unfolded = m * r + r * r + r * n
    folded = m * r + r * n
    return m * n, unfolded, folded, (folded if fold_u else unfolded)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _decompose(W, r, cur_cfg: CURConfig, act, seed):
    """The per-weight chain on one weight or a stack: selection, link
    solve, reconstruction error, Theorem 3.1 bound."""
    p, q, aux = select_indices(W, r, cur_cfg.selection, act, seed,
                               cur_cfg.svd)
    Wf = W.float()
    C, U, R = cur_from_indices(Wf, p, q)
    err = torch.linalg.norm(Wf - C @ U @ R, dim=(-2, -1))
    if "P" in aux and aux["sig"].shape[-1] > r:
        bound = spectral_error_bound(
            aux["P"][..., :r], aux["Q"][..., :r], aux["sig"], p, q)
    else:
        bound = torch.full_like(err, float("nan"))
    frow = torch.linalg.norm(Wf, dim=(-2, -1))
    return p, q, C, U, R, err, frow, bound


def _leaf(C, U, R, dtype) -> dict:
    return {"C": C.to(dtype), "U0": U.float(),
            "dU": torch.zeros_like(U, dtype=torch.float32),
            "R": R.to(dtype)}


@torch.no_grad()
def compress_weight(W: torch.Tensor, name: str, layer: int,
                    cur_cfg: CURConfig, act_sq, seed: int,
                    rank: Optional[int] = None) -> Tuple[dict, WeightInfo]:
    """Single-weight reference path (also the ``pipeline="loop"`` body)."""
    t0 = time.perf_counter()
    m, n = W.shape
    r = rank if rank is not None else resolve_rank(m, n, layer, name, cur_cfg)
    p, q, C, U, R, err, frow, bound = _decompose(W, r, cur_cfg, act_sq, seed)
    leaf = _leaf(C, U, R, W.dtype)
    idx = torch.stack([p, q]).cpu().numpy()
    scal = torch.stack([err, frow, bound.to(err.device)]).cpu().numpy()
    dt = time.perf_counter() - t0
    before, unfolded, folded, deployed = _param_counts(
        m, n, r, cur_cfg.fold_u)
    info = WeightInfo(
        layer=layer, name=name, shape=(m, n), rank=r,
        rows=idx[0], cols=idx[1],
        fro_err=float(scal[0]), fro_w=float(scal[1]), bound=float(scal[2]),
        seconds=dt, params_before=before, params_after=deployed,
        params_after_unfolded=unfolded, params_after_folded=folded,
        bound_on=_bound_on(cur_cfg.selection))
    return leaf, info


# ---------------------------------------------------------------------------
# batched pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _WorkItem:
    layer: int
    name: str
    W: torch.Tensor
    act: Optional[np.ndarray]
    seed: int
    rank: int = 0


@torch.no_grad()
def _compress_batched(work: List[_WorkItem], cur_cfg: CURConfig):
    """Run the work list grouped by (m, n, r) shape-class; returns
    (leaf, WeightInfo) per item, in work-list order."""
    classes: Dict[Tuple[int, int, int], List[int]] = {}
    for i, it in enumerate(work):
        classes.setdefault(tuple(it.W.shape) + (it.rank,), []).append(i)

    results: List[Optional[Tuple[dict, WeightInfo]]] = [None] * len(work)
    for (m, n, r), idxs in classes.items():
        t0 = time.perf_counter()
        Ws = torch.stack([work[i].W for i in idxs])
        dev = Ws.device
        acts = torch.stack([
            torch.as_tensor(work[i].act, dtype=torch.float32, device=dev)
            if work[i].act is not None
            else torch.zeros((m,), dtype=torch.float32, device=dev)
            for i in idxs])
        p, q, C, U, R, err, frow, bound = _decompose(
            Ws, r, cur_cfg, acts, [work[i].seed for i in idxs])
        # one host transfer per class for the index and scalar fields;
        # the factors stay on the device in the returned leaves
        idx = torch.stack([p, q]).cpu().numpy()
        scal = torch.stack([err, frow, bound.to(err.device)]).cpu().numpy()
        dt = (time.perf_counter() - t0) / len(idxs)
        before, unfolded, folded, deployed = _param_counts(
            m, n, r, cur_cfg.fold_u)
        for k, i in enumerate(idxs):
            it = work[i]
            info = WeightInfo(
                layer=it.layer, name=it.name, shape=(m, n), rank=r,
                rows=idx[0, k], cols=idx[1, k],
                fro_err=float(scal[0, k]), fro_w=float(scal[1, k]),
                bound=float(scal[2, k]), seconds=dt,
                params_before=before, params_after=deployed,
                params_after_unfolded=unfolded, params_after_folded=folded,
                bound_on=_bound_on(cur_cfg.selection))
            results[i] = (_leaf(C[k], U[k], R[k], it.W.dtype), info)
    return results


def fold_cur(leaf: dict) -> dict:
    """Deploy-time fold: C' = C @ (U0 + dU) — halves the matmul chain."""
    cu = leaf["C"].float() @ (leaf["U0"] + leaf["dU"])
    return {"CU": cu.to(leaf["C"].dtype), "R": leaf["R"]}


def unrolled_config(cfg: ModelConfig) -> ModelConfig:
    """Per-layer groups so compressed/dense layers can differ in structure."""
    groups = tuple(((spec,), 1) for spec in cfg.blocks)
    return cfg.replace(groups=groups, scan_layers=False)


def unroll_params(params, cfg: ModelConfig):
    """Restructure params to match ``unrolled_config`` (views, no copies)."""
    new = {k: v for k, v in params.items() if k != "groups"}
    new["groups"] = []
    for li, spec, lp in iter_layer_params(params, cfg):
        new["groups"].append([tree_map(lambda a: a[None], lp)])
    return new


def _item_seed(seed: int, index: int) -> int:
    """Seed of the index-th weight (network order) of a compression."""
    return seed * 1_000_003 + index


def _cur_work_list(params, cfg: ModelConfig, cur_cfg: CURConfig,
                   calib: CalibStats, layer_set) -> List[_WorkItem]:
    """Enumerate compressible weights in network order, each with its own
    seed — identical for the loop and batched pipelines."""
    work: List[_WorkItem] = []
    for li, spec, lp in iter_layer_params(params, cfg):
        if li not in layer_set:
            continue
        for t in cfg.cur_targets:
            if t not in lp:
                continue
            W = lp[t]
            if isinstance(W, dict) or W.dim() != 2:
                continue                 # already compressed / expert stacks
            if cur_cfg.ranks and rank_key(li, t) not in cur_cfg.ranks:
                continue                 # a ranks map is the whole plan
            act = calib.act_sq[li].get(t) if calib.act_sq else None
            if act is None and cur_cfg.selection in ("wanda_deim", "wanda"):
                raise ValueError(
                    f"no calibration activations for layer {li} weight {t}")
            work.append(_WorkItem(li, t, W, act,
                                  _item_seed(cur_cfg.seed, len(work)),
                                  resolve_rank(W.shape[0], W.shape[1],
                                               li, t, cur_cfg)))
    return work


@torch.no_grad()
def compress_model(params, cfg: ModelConfig, cur_cfg: CURConfig,
                   calib: CalibStats, layers: Optional[List[int]] = None):
    """Returns (new_params, new_cfg, CompressInfo). The new params share
    every untouched tensor with ``params``."""
    t_start = time.perf_counter()
    distances = angular.layer_distances(calib.hidden)
    if layers is None:
        layers = angular.select_layers(
            distances, cur_cfg.n_compress_layers,
            cur_cfg.layer_selection, cur_cfg.seed)
    layer_set = set(layers)
    _validate_ranks(params, cfg, cur_cfg, layer_set)

    new_cfg = unrolled_config(cfg)
    new_params = unroll_params(params, cfg)

    work = _cur_work_list(params, cfg, cur_cfg, calib, layer_set)
    if cur_cfg.pipeline == "loop":
        results = [compress_weight(it.W, it.name, it.layer, cur_cfg,
                                   it.act, it.seed, rank=it.rank)
                   for it in work]
    elif cur_cfg.pipeline == "batched":
        results = _compress_batched(work, cur_cfg)
    else:
        raise ValueError(cur_cfg.pipeline)

    infos: List[WeightInfo] = []
    seconds_fold = 0.0
    for it, (leaf, info) in zip(work, results):
        if info.params_after >= info.params_before:
            continue                             # Eq. 2 guard, deployed form
        if cur_cfg.fold_u:
            t_fold = time.perf_counter()
            leaf = fold_cur(leaf)
            _sync(leaf["CU"].device)
            seconds_fold += time.perf_counter() - t_fold
        block = new_params["groups"][it.layer][0]
        block[it.name] = tree_map(lambda a: a[None], leaf)
        infos.append(info)

    cinfo = CompressInfo(
        distances=distances, layers=sorted(layer_set), weights=infos,
        seconds_total=time.perf_counter() - t_start,
        seconds_fold=seconds_fold)
    return new_params, new_cfg, cinfo
