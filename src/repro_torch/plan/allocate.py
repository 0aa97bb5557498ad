"""Budget-driven rank allocation over sensitivity curves.

Turns a global budget — parameters, bytes, or single-card roofline
latency (``repro_torch.roofline.analysis``, the H100's) — into per-weight
ranks that minimize the total squared Frobenius error predicted by a
``SensitivityProfile``. Two solvers:

  - ``greedy``: Lagrangian-style marginal-error descent. Every weight
    starts at its highest feasible grid rank (lowest error); while over
    budget, decrement the weight whose next step down costs the least
    error increase per unit of budget reclaimed. Classic rate-distortion
    allocation; optimal when the curves are convex in cost, near-optimal
    otherwise, O(N · |grid| log N).
  - ``dp``: exact multiple-choice-knapsack dynamic program for small N.
    Costs are used at unit resolution when the budget is small enough and
    quantized into ``dp_bins`` units otherwise (still optimal at the
    quantized resolution).

The result is a serializable, versioned ``CompressionPlan`` carrying the
per-weight ranks (keyed ``"layer:name"`` as ``CURConfig.ranks`` expects),
the realized-vs-requested budget, predicted errors, and provenance hashes
of the model config + calibration stats, so a saved plan reproduces the
exact same compression later (``launch/cure.py --plan``).
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import CURConfig
from repro_torch.core import angular
from repro_torch.plan.sensitivity import (
    SensitivityProfile, WeightCurve, profile_sensitivity)
from repro_torch.roofline.analysis import cur_latency_s, gemm_latency_s

PLAN_VERSION = 1

BUDGET_KINDS = ("params", "bytes", "latency_ms")


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

def weight_cost(m: int, n: int, r: int, kind: str, *, fold_u: bool,
                dtype_bytes: int) -> float:
    """Deployed cost of one CUR-compressed (m, n) weight at rank r."""
    params = m * r + r * n + (0 if fold_u else r * r)
    if kind == "params":
        return float(params)
    if kind == "bytes":
        return float(params) * dtype_bytes
    if kind == "latency_ms":
        return 1e3 * cur_latency_s(m, n, r, dtype_bytes=dtype_bytes,
                                   folded=fold_u)
    raise ValueError(f"budget kind {kind!r} not in {BUDGET_KINDS}")


def dense_cost(m: int, n: int, kind: str, *, dtype_bytes: int) -> float:
    """Cost of leaving the weight dense (the pre-compression baseline a
    fractional budget is relative to)."""
    if kind == "params":
        return float(m * n)
    if kind == "bytes":
        return float(m * n) * dtype_bytes
    if kind == "latency_ms":
        return 1e3 * gemm_latency_s(m, n, dtype_bytes=dtype_bytes)
    raise ValueError(f"budget kind {kind!r} not in {BUDGET_KINDS}")


def resolve_budget(curves: Sequence[WeightCurve], kind: str, value: float,
                   *, dtype_bytes: int) -> float:
    """Absolute budget. For params/bytes a value <= 1.0 is a fraction of
    the targeted weights' dense total; larger values are absolute counts.
    Latency budgets are always absolute milliseconds."""
    if kind == "latency_ms" or value > 1.0:
        return float(value)
    total = sum(dense_cost(c.shape[0], c.shape[1], kind,
                           dtype_bytes=dtype_bytes) for c in curves)
    return float(value) * total


# ---------------------------------------------------------------------------
# the plan artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionPlan:
    version: int
    arch: str
    budget_kind: str
    budget_requested: float          # absolute, in budget_kind units
    solver: str
    layers: List[int]
    ranks: Dict[str, int]            # "layer:name" -> rank
    selection: str
    svd: str
    fold_u: bool
    seed: int
    feasible: bool                   # realized <= requested?
    realized: Dict[str, float]       # params/bytes/latency_ms before+after
    predicted: Dict[str, float]      # objective + per-weight rel_err
    provenance: Dict[str, object]    # cfg_hash, calib_hash, grid

    def to_cur_config(self, base: Optional[CURConfig] = None) -> CURConfig:
        """The CURConfig that executes this plan (pair with
        ``compress_model(..., layers=plan.layers)``)."""
        base = base or CURConfig()
        return dataclasses.replace(
            base, enabled=True, ranks=dict(self.ranks),
            selection=self.selection, svd=self.svd, fold_u=self.fold_u,
            seed=self.seed, n_compress_layers=len(self.layers))

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["budget"] = {"kind": d.pop("budget_kind"),
                       "requested": d.pop("budget_requested"),
                       "feasible": d.pop("feasible"),
                       "realized": d.pop("realized")}
        d["cur"] = {"selection": d.pop("selection"), "svd": d.pop("svd"),
                    "fold_u": d.pop("fold_u"), "seed": d.pop("seed")}
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CompressionPlan":
        d = json.loads(text)
        if d.get("version") != PLAN_VERSION:
            raise ValueError(
                f"plan version {d.get('version')} != {PLAN_VERSION}")
        b, c = d["budget"], d["cur"]
        return cls(
            version=d["version"], arch=d["arch"], budget_kind=b["kind"],
            budget_requested=float(b["requested"]), solver=d["solver"],
            layers=[int(x) for x in d["layers"]],
            ranks={k: int(v) for k, v in d["ranks"].items()},
            selection=c["selection"], svd=c["svd"], fold_u=bool(c["fold_u"]),
            seed=int(c["seed"]), feasible=bool(b["feasible"]),
            realized=dict(b["realized"]), predicted=dict(d["predicted"]),
            provenance=dict(d["provenance"]))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "CompressionPlan":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def _tables(curves: Sequence[WeightCurve], kind: str, fold_u: bool,
            dtype_bytes: int, objective: str):
    """Per weight: ascending (cost, err2) options, one per grid rank.
    err2 is a squared ABSOLUTE error so it sums across weights:
      - "func" (default): activation-weighted Frobenius error — tracks
        the layer's expected output distortion, the better ppl proxy;
      - "fro": plain reconstruction error ||W - CUR||_F."""
    if objective not in ("func", "fro"):
        raise ValueError(f"objective {objective!r} not in ('func', 'fro')")
    costs, errs2 = [], []
    for c in curves:
        m, n = c.shape
        costs.append([weight_cost(m, n, r, kind, fold_u=fold_u,
                                  dtype_bytes=dtype_bytes) for r in c.grid])
        if objective == "func":
            errs2.append([(float(e) * c.func_fro_w) ** 2
                          for e in c.func_err])
        else:
            errs2.append([(float(e) * c.fro_w) ** 2 for e in c.rel_err])
    return costs, errs2


def _solve_greedy(curves, costs, errs2, budget: float):
    """Marginal-error descent from the top of every curve."""
    level = [len(c.grid) - 1 for c in curves]      # grid index per weight
    total = sum(costs[i][level[i]] for i in range(len(curves)))

    def push(heap, i):
        li = level[i]
        if li == 0:
            return
        d_err = errs2[i][li - 1] - errs2[i][li]    # >= 0 (err grows down)
        d_cost = costs[i][li] - costs[i][li - 1]   # > 0
        heapq.heappush(heap, (d_err / max(d_cost, 1e-30), i, li))

    heap: List[Tuple[float, int, int]] = []
    for i in range(len(curves)):
        push(heap, i)
    while total > budget and heap:
        _, i, li = heapq.heappop(heap)
        if level[i] != li:                         # stale entry
            continue
        total -= costs[i][li] - costs[i][li - 1]
        level[i] = li - 1
        push(heap, i)

    # refill pass: the descent overshoots by up to one grid step — spend
    # the slack on the upgrades with the best error reduction per cost
    # (a coarse grid otherwise strands budget vs the uniform baseline)
    while True:
        best, gain = None, 0.0
        for i in range(len(curves)):
            li = level[i]
            if li + 1 >= len(costs[i]):
                continue
            d_cost = costs[i][li + 1] - costs[i][li]
            if total + d_cost > budget:
                continue
            d_err = errs2[i][li] - errs2[i][li + 1]
            if d_err / max(d_cost, 1e-30) > gain:
                best, gain = i, d_err / max(d_cost, 1e-30)
        if best is None:
            break
        level[best] += 1
        total += costs[best][level[best]] - costs[best][level[best] - 1]
    return level, total


def _solve_dp(curves, costs, errs2, budget: float, dp_bins: int):
    """Exact multiple-choice knapsack (minimize total err2 s.t. total cost
    <= budget). Unit resolution when costs are integral (params/bytes)
    and the budget is small; otherwise quantized to ``dp_bins`` units
    (costs rounded UP, so the realized cost of the solution never exceeds
    the requested budget). Fractional costs (latency budgets) always take
    the quantized path — unit 1.0 would round every sub-unit cost up to a
    full budget unit and starve the knapsack."""
    integral = all(float(c).is_integer() for row in costs for c in row)
    unit = 1.0 if integral and budget <= dp_bins * 64 else budget / dp_bins
    cap = int(np.floor(budget / unit))
    q = [[int(np.ceil(c / unit)) for c in row] for row in costs]

    INF = float("inf")
    best = np.full(cap + 1, INF)
    best[0] = 0.0
    choice = []                                    # per weight: (cap+1,) pick
    for i in range(len(curves)):
        nxt = np.full(cap + 1, INF)
        pick = np.full(cap + 1, -1, np.int64)
        for li in range(len(q[i])):
            c, e = q[i][li], errs2[i][li]
            if c > cap:
                continue
            cand = best[:cap + 1 - c] + e
            win = cand < nxt[c:]
            nxt[c:][win] = cand[win]
            pick[c:][win] = li
        choice.append(pick)
        best = nxt
    end = int(np.argmin(best))
    if not np.isfinite(best[end]):
        # even the cheapest ranks overflow the quantized budget —
        # fall back to all-minimum (the infeasible case)
        level = [0] * len(curves)
        return level, sum(costs[i][0] for i in range(len(curves)))
    level = [0] * len(curves)
    rem = end
    for i in range(len(curves) - 1, -1, -1):
        li = int(choice[i][rem])
        level[i] = li
        rem -= q[i][li]
    total = sum(costs[i][level[i]] for i in range(len(curves)))
    return level, total


def allocate(profile: SensitivityProfile, budget_kind: str,
             budget_value: float, *, arch: str = "", solver: str = "greedy",
             fold_u: bool = True, dtype_bytes: int = 4, seed: int = 0,
             dp_bins: int = 4096, objective: str = "func",
             ) -> CompressionPlan:
    """Allocate per-weight ranks under the budget. Every profiled weight
    is compressed (not compressing costs MORE than any CUR rank — the
    budget can only be met by compressing); if even the minimum grid
    ranks overflow the budget the plan is returned with
    ``feasible=False`` rather than raising, so callers can inspect it."""
    if budget_kind not in BUDGET_KINDS:
        raise ValueError(f"budget kind {budget_kind!r} not in {BUDGET_KINDS}")
    if solver not in ("greedy", "dp"):
        raise ValueError(f"solver {solver!r} not in ('greedy', 'dp')")
    curves = profile.curves
    if not curves:
        raise ValueError("profile has no feasible weights to allocate")
    t0 = time.perf_counter()
    budget = resolve_budget(curves, budget_kind, budget_value,
                            dtype_bytes=dtype_bytes)
    costs, errs2 = _tables(curves, budget_kind, fold_u, dtype_bytes,
                           objective)
    if solver == "greedy":
        level, total = _solve_greedy(curves, costs, errs2, budget)
    else:
        level, total = _solve_dp(curves, costs, errs2, budget, dp_bins)

    ranks = {c.key: int(c.grid[level[i]]) for i, c in enumerate(curves)}
    rel_err = {c.key: float(c.rel_err[level[i]])
               for i, c in enumerate(curves)}
    total_err2 = sum(errs2[i][level[i]] for i in range(len(curves)))

    def totals(kind: str) -> Tuple[float, float]:
        before = sum(dense_cost(c.shape[0], c.shape[1], kind,
                                dtype_bytes=dtype_bytes) for c in curves)
        after = sum(weight_cost(c.shape[0], c.shape[1], ranks[c.key], kind,
                                fold_u=fold_u, dtype_bytes=dtype_bytes)
                    for c in curves)
        return before, after

    realized: Dict[str, float] = {}
    for kind in BUDGET_KINDS:
        before, after = totals(kind)
        realized[f"{kind}_before"] = round(before, 6)
        realized[f"{kind}_after"] = round(after, 6)
    realized["fraction"] = round(
        realized[f"{budget_kind}_after"]
        / max(realized[f"{budget_kind}_before"], 1e-30), 6)

    return CompressionPlan(
        version=PLAN_VERSION, arch=arch, budget_kind=budget_kind,
        budget_requested=budget, solver=solver,
        layers=sorted({c.layer for c in curves}), ranks=ranks,
        selection=profile.selection, svd=profile.svd, fold_u=fold_u,
        seed=seed, feasible=bool(total <= budget * (1 + 1e-9)),
        realized=realized,
        predicted={"objective": round(total_err2, 8),
                   "objective_kind": objective,
                   "rel_err": {k: round(v, 6) for k, v in rel_err.items()},
                   "solve_seconds": round(time.perf_counter() - t0, 4)},
        provenance={"cfg_hash": profile.cfg_hash,
                    "calib_hash": profile.calib_hash,
                    "grid": list(profile.grid)})


def dtype_bytes_for(cfg) -> int:
    """Budget accounting itemsize for a model config's weight dtype."""
    return 2 if "16" in cfg.dtype else 4


def plan_for_model(params, cfg, cur_cfg: CURConfig, calib, *,
                   budget_kind: str, budget_value: float,
                   n_layers: int, grid=None, solver: str = "greedy",
                   arch: str = "") -> Tuple[CompressionPlan,
                                            SensitivityProfile]:
    """The full planning pass: angular layer choice (same rule as
    ``compress_model``) -> sensitivity profile of those layers -> budget
    allocation."""
    distances = angular.layer_distances(calib.hidden)
    layers = angular.select_layers(
        distances, n_layers, cur_cfg.layer_selection, cur_cfg.seed)
    profile = profile_sensitivity(params, cfg, cur_cfg, calib, grid=grid,
                                  layers=layers)
    plan = allocate(profile, budget_kind, budget_value, arch=arch,
                    solver=solver, fold_u=cur_cfg.fold_u,
                    dtype_bytes=dtype_bytes_for(cfg), seed=cur_cfg.seed)
    return plan, profile


def budget_from_args(args, *, required: bool = True):
    """(kind, value) of the one ``--budget-params`` / ``--budget-bytes`` /
    ``--budget-latency-ms`` flag a launcher was given; None when none was
    and ``required`` is false. Raises SystemExit on two or more."""
    picks = [(k, v) for k, v in (
        ("params", args.budget_params), ("bytes", args.budget_bytes),
        ("latency_ms", args.budget_latency_ms)) if v is not None]
    if len(picks) > 1 or (required and not picks):
        raise SystemExit(
            f"pass {'exactly' if required else 'at most'} one of "
            "--budget-params / --budget-bytes / --budget-latency-ms")
    return picks[0] if picks else None


def parse_grid(text):
    """``--grid``'s comma-separated ranks; None (the default grid) when
    empty."""
    return tuple(int(x) for x in text.split(",")) if text else None
