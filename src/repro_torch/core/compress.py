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

Spans (``obs.Tracer``, on lane ``TRACK`` of the tracer given to
``compress_model``; ``torch.profiler`` ranges of the same names while a
capture records, with or without a tracer): ``cur.compress`` one call
(attribute layers) > ``cur.class`` one (m, n, r) shape class, or one
weight in the loop pipeline (m, n, r, k weights) > ``cur.wanda`` the
WANDA score, ``cur.svd`` the SVD (method; route, of the exact SVD:
``core.cur.exact_svd``), ``cur.deim`` both DEIM calls (steps),
``cur.link`` the C and R gathers and U = C+ W R+, ``cur.error`` the
Frobenius error and the Theorem 3.1 bound,
``cur.readback`` the indices' and scalars' host copy; ``cur.fold`` one
fold, under ``cur.compress``. ``cur.experts`` (layer, k, m, n, r) holds
the ``cur.class`` of a class with expert weights in it.

Targets (``ModelConfig.cur_targets``) name a block's 2-D weights
(``wq``, ``w_gate``), a nested one (``shared.w_gate``: the shared
expert's gate), or ``experts.<name>``: each held routed expert's weight
of the (E, m, n) stack ``<name>`` as a weight of its own (its own WANDA
statistics, over the tokens routed to it, and its own seed). A stack is
CURed whole or not at all and restacked as ``{"CU": (E, m, r), "R":
(E, r, n)}`` (or the healing form). A bare name of an expert stack
(``w_gate`` in a MoE layer) is not a 2-D weight and stays dense. A
``ranks`` plan names no expert, so under one the experts stay dense.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.configs.base import CURConfig, ModelConfig
from repro_torch.core import angular, cur
from repro_torch.core.calibrate import CalibStats
from repro_torch.core.cur import (
    cur_from_indices, exact_svd, randomized_svd, rank_for,
    spectral_error_bound)
from repro_torch.core.deim import deim
from repro_torch.core.wanda import wanda_scores
from repro_torch.models.model import iter_layer_params
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import NULL_TRACER, Tracer

# the Chrome-trace lane of the cur.* spans
TRACK = 1
# the tracer of the compress_model call in progress: the stage functions
# keep their signatures (checks patch them by name and call them so)
_tracer: contextvars.ContextVar = contextvars.ContextVar(
    "cur_tracer", default=NULL_TRACER)


def _span(name: str, **attrs):
    return _tracer.get().span(name, track=TRACK, **attrs)


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
    # the held expert's index in its stack (an ``experts.*`` target)
    expert: Optional[int] = None


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


def sketch_matrices(seeds: Sequence[int], n: int, k: int,
                    device) -> torch.Tensor:
    """The randomized SVD's Gaussian test matrices (len(seeds), n, k), each
    drawn from its own generator seeded by its weight's item seed."""
    return torch.stack([
        torch.randn((n, k), generator=_generator(s, device), device=device)
        for s in seeds])


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
            g = sketch_matrices(seeds, M.shape[-1],
                                min(rr + 8, min(M.shape[-2:])), dev)
            g = g if batched else g[0]
        return randomized_svd(M, rr, G=g)

    def wanda():
        with _span("cur.wanda"):
            return wanda_scores(W, torch.as_tensor(act_sq, device=dev))

    def svd_deim(M):
        with _span("cur.svd", method=svd_method) as span:
            cur.svd_route.set(None)
            P, sig, Q = svd_fn(M, k_svd)
            if svd_method == "exact":
                span.set(route=cur.svd_route.get())
        with _span("cur.deim", steps=2 * (r - 1)):
            p, q = deim(P[..., :r]), deim(Q[..., :r])
        return p, q, {"P": P, "Q": Q, "sig": sig}

    aux = {}
    k_svd = min(r + 1, min(W.shape[-2:]))
    if method == "wanda_deim":
        p, q, aux = svd_deim(wanda())
    elif method == "wanda":
        S = wanda()
        p = _top_k_indices(torch.linalg.norm(S, dim=-1), r)
        q = _top_k_indices(torch.linalg.norm(S, dim=-2), r)
    elif method == "deim":
        p, q, aux = svd_deim(W.float())
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
            W = _target(lp, t)
            if (W is None or isinstance(W, dict) or W.dim() != 2
                    or t.startswith(EXPERTS)):
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
    with _span("cur.link"):
        Wf = W.float()
        C, U, R = cur_from_indices(Wf, p, q)
    with _span("cur.error"):
        err = torch.linalg.norm(Wf - C @ U @ R, dim=(-2, -1))
        if "P" in aux and aux["sig"].shape[-1] > r:
            bound = spectral_error_bound(
                aux["P"][..., :r], aux["Q"][..., :r], aux["sig"], p, q)
        else:
            bound = torch.full_like(err, float("nan"))
        frow = torch.linalg.norm(Wf, dim=(-2, -1))
    return p, q, C, U, R, err, frow, bound


def _readback(p, q, err, frow, bound):
    """The indices and the scalars, copied to the host."""
    with _span("cur.readback"):
        idx = torch.stack([p, q]).cpu().numpy()
        scal = torch.stack([err, frow, bound.to(err.device)]).cpu().numpy()
    return idx, scal


def _leaf(C, U, R, dtype) -> dict:
    return {"C": C.to(dtype), "U0": U.float(),
            "dU": torch.zeros_like(U, dtype=torch.float32),
            "R": R.to(dtype)}


@torch.no_grad()
def compress_weight(W: torch.Tensor, name: str, layer: int,
                    cur_cfg: CURConfig, act_sq, seed: int,
                    rank: Optional[int] = None,
                    expert: Optional[int] = None) -> Tuple[dict, WeightInfo]:
    """Single-weight reference path (also the ``pipeline="loop"`` body)."""
    t0 = time.perf_counter()
    m, n = W.shape
    r = rank if rank is not None else resolve_rank(m, n, layer, name, cur_cfg)
    with _experts_span(expert is not None, layer, 1, m, n, r), \
            _span("cur.class", m=m, n=n, r=r, k=1):
        p, q, C, U, R, err, frow, bound = _decompose(W, r, cur_cfg, act_sq,
                                                     seed)
        idx, scal = _readback(p, q, err, frow, bound)
    dt = time.perf_counter() - t0            # ends at the host transfer
    leaf = _leaf(C, U, R, W.dtype)
    obs_metrics.histogram(
        "repro_compress_weight_s",
        "per-weight CUR time (loop pipeline / reference path)").observe(dt)
    before, unfolded, folded, deployed = _param_counts(
        m, n, r, cur_cfg.fold_u)
    info = WeightInfo(
        layer=layer, name=name, shape=(m, n), rank=r,
        rows=idx[0], cols=idx[1],
        fro_err=float(scal[0]), fro_w=float(scal[1]), bound=float(scal[2]),
        seconds=dt, params_before=before, params_after=deployed,
        params_after_unfolded=unfolded, params_after_folded=folded,
        bound_on=_bound_on(cur_cfg.selection), expert=expert)
    return leaf, info


def _experts_span(experts: bool, layer, k: int, m: int, n: int, r: int):
    """The ``cur.experts`` span of a class holding expert weights (else
    nothing)."""
    if not experts:
        return contextlib.nullcontext()
    return _span("cur.experts", layer=layer, k=k, m=m, n=n, r=r)


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
    expert: Optional[int] = None


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
        experts = [work[i] for i in idxs if work[i].expert is not None]
        layers = sorted({it.layer for it in experts})
        with _experts_span(bool(experts), layers[0] if len(layers) == 1
                           else layers, len(idxs), m, n, r), \
                _span("cur.class", m=m, n=n, r=r, k=len(idxs)):
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
            idx, scal = _readback(p, q, err, frow, bound)
        dt = (time.perf_counter() - t0) / len(idxs)
        # per-shape-class timing, ending at the class's host transfer; the
        # label space is open-ended but small in practice, so overflow
        # degrades to NULL instead of raising mid-compression
        obs_metrics.default_registry().histogram(
            "repro_compress_class_s",
            "per-weight seconds by (m,n,r) shape-class",
            labels=("shape",), overflow="drop").labels(
            shape=f"{m}x{n}r{r}").observe(dt)
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
                bound_on=_bound_on(cur_cfg.selection), expert=it.expert)
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


EXPERTS = "experts."


def _target(lp: dict, t: str):
    """The leaf a target names in a layer's params (None where it has
    none): ``a.b`` is ``lp["a"]["b"]``, ``experts.b`` the stack
    ``lp["b"]``."""
    if t.startswith(EXPERTS):
        return lp.get(t[len(EXPERTS):])
    head, _, rest = t.partition(".")
    leaf = lp.get(head)
    if rest:
        return leaf.get(rest) if isinstance(leaf, dict) else None
    return leaf


def _set_target(block: dict, t: str, leaf) -> None:
    """Write a target's new leaf into a layer's (unrolled) params."""
    if t.startswith(EXPERTS):
        block[t[len(EXPERTS):]] = leaf
        return
    head, _, rest = t.partition(".")
    if rest:
        block[head] = dict(block[head], **{rest: leaf})
    else:
        block[head] = leaf


def _cur_work_list(params, cfg: ModelConfig, cur_cfg: CURConfig,
                   calib: CalibStats, layer_set) -> List[_WorkItem]:
    """Enumerate compressible weights in network order (a stack's experts
    in index order), each with its own seed — identical for the loop and
    batched pipelines."""
    work: List[_WorkItem] = []
    for li, spec, lp in iter_layer_params(params, cfg):
        if li not in layer_set:
            continue
        for t in cfg.cur_targets:
            W = _target(lp, t)
            if W is None or isinstance(W, dict):
                continue                 # absent / already compressed
            expert = t.startswith(EXPERTS)
            if W.dim() != (3 if expert else 2):
                continue                 # an expert stack named bare
            if cur_cfg.ranks and rank_key(li, t) not in cur_cfg.ranks:
                continue                 # a ranks map is the whole plan
            act = calib.act_sq[li].get(t) if calib.act_sq else None
            if act is None and cur_cfg.selection in ("wanda_deim", "wanda"):
                raise ValueError(
                    f"no calibration activations for layer {li} weight {t}")
            items = [(None, W, act)]
            if expert:
                routed = (calib.expert_tokens[li] if calib.expert_tokens
                          else None)
                if act is not None and (routed is None or
                                        (routed[:W.shape[0]] <= 0).any()):
                    raise ValueError(
                        f"layer {li} weight {t}: a held expert saw no "
                        "calibration token")
                items = [(e, W[e], None if act is None else act[e])
                         for e in range(W.shape[0])]
            for e, We, ae in items:
                work.append(_WorkItem(li, t, We, ae,
                                      _item_seed(cur_cfg.seed, len(work)),
                                      resolve_rank(We.shape[0], We.shape[1],
                                                   li, t, cur_cfg), e))
    return work


@torch.no_grad()
def compress_model(params, cfg: ModelConfig, cur_cfg: CURConfig,
                   calib: CalibStats, layers: Optional[List[int]] = None,
                   tracer: Optional[Tracer] = None):
    """Returns (new_params, new_cfg, CompressInfo). The new params share
    every untouched tensor with ``params``. ``tracer`` keeps the cur.*
    spans, on its lane ``TRACK``."""
    tracer = tracer or NULL_TRACER
    if tracer.enabled:
        tracer.name_track(TRACK, "cur")
    token = _tracer.set(tracer)
    try:
        with _span("cur.compress") as span:
            return _compress_model(params, cfg, cur_cfg, calib, layers, span)
    finally:
        _tracer.reset(token)


def _compress_model(params, cfg, cur_cfg, calib, layers, span):
    t_start = time.perf_counter()
    distances = angular.layer_distances(calib.hidden)
    if layers is None:
        layers = angular.select_layers(
            distances, cur_cfg.n_compress_layers,
            cur_cfg.layer_selection, cur_cfg.seed)
    layer_set = set(layers)
    span.set(layers=len(layer_set))
    _validate_ranks(params, cfg, cur_cfg, layer_set)

    new_cfg = unrolled_config(cfg)
    new_params = unroll_params(params, cfg)

    work = _cur_work_list(params, cfg, cur_cfg, calib, layer_set)
    if cur_cfg.pipeline == "loop":
        results = [compress_weight(it.W, it.name, it.layer, cur_cfg,
                                   it.act, it.seed, rank=it.rank,
                                   expert=it.expert)
                   for it in work]
    elif cur_cfg.pipeline == "batched":
        results = _compress_batched(work, cur_cfg)
    else:
        raise ValueError(cur_cfg.pipeline)

    # one entry a target of a layer: its items' (leaf, info), a stack's
    # in expert order
    targets: Dict[Tuple[int, str], list] = {}
    for it, res in zip(work, results):
        targets.setdefault((it.layer, it.name), []).append(res)
    infos: List[WeightInfo] = []
    seconds_fold = 0.0
    for (li, name), done in targets.items():
        if any(info.params_after >= info.params_before for _, info in done):
            continue                             # Eq. 2 guard, deployed form
        leaf = done[0][0]
        if done[0][1].expert is not None:        # restack the experts
            leaf = {k: torch.stack([lf[k] for lf, _ in done])
                    for k in leaf}
        if cur_cfg.fold_u:
            t_fold = time.perf_counter()
            with _span("cur.fold"):
                leaf = fold_cur(leaf)
                _sync(leaf["CU"].device)
            seconds_fold += time.perf_counter() - t_fold
        _set_target(new_params["groups"][li][0], name,
                    tree_map(lambda a: a[None], leaf))
        infos.extend(info for _, info in done)

    cinfo = CompressInfo(
        distances=distances, layers=sorted(layer_set), weights=infos,
        seconds_total=time.perf_counter() - t_start,
        seconds_fold=seconds_fold)
    obs_metrics.counter(
        "repro_compress_time_s_total",
        "compress_model wall seconds").inc(cinfo.seconds_total)
    obs_metrics.counter(
        "repro_compress_fold_time_s_total",
        "seconds folding C@U").inc(seconds_fold)
    obs_metrics.counter(
        "repro_compress_weights_total",
        "weights CUR-compressed").inc(len(infos))
    obs_metrics.counter(
        "repro_compress_expert_weights_total",
        "routed experts' weights CUR-compressed (one an expert)").inc(
        sum(w.expert is not None for w in infos))
    return new_params, new_cfg, cinfo
