"""CURing cells: one user compressing a model stage with the paper's
settings, a layer at a time.

Set-up: weights made on the card from the seed, the program's
calibration pass over ``calib_batch`` x ``calib_len`` tokens, its
angular layer selection, and one layer compressed once to warm the
SVD's and DEIM's shapes. The window then runs the program's
``compress_model`` on one selected layer at a time in the mix's order
(exact SVD, WANDA x DEIM, folded), and ends at a layer boundary once
``seconds`` have passed: ``cure_layer_s`` is the window's wall seconds
over the layers it CURed.

While the cell runs, the program's ``select_indices`` and
``wanda_scores`` are wrapped so that what each call of the timed path
returned is kept (the WANDA score S, the singular triplets P, sig, Q,
the DEIM indices); nothing is computed there. After the window, the
check holds every weight of the last pass over the layers against the
plain reference (``reference/cur.py``), stage by stage:

- ``wanda_gap``: the program's S against the reference's, worked out
  from the dense weight and the reference's own float32 calibration;
- ``svd_gap``: how far the program's P, sig, Q are from the leading
  singular triplets of the program's S (the residuals, and no direction
  of S left above the last value kept); their departure from
  orthonormal columns, ``svd_orth``, is reported beside it and not
  compared (the program's CUDA SVD leaves it at the size float8
  rounding gives, see PERF.md);
- ``deim_gap``: DEIM followed over the program's P and Q: how far the
  residual at each row and column the program reports lies below the
  largest;
- ``fold_gap``: the program's C' = C U against C C+ W R+ solved from the
  dense weight at the program's indices, plus R against those rows of W;
- ``weights_missing``: targets of the last pass the program did not
  compress.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from harness import common, traffic
from harness.profile import Trace, launches


UNITS = {"cure_layer_s": "s"}
NUMBERS = ("wanda_gap", "svd_gap", "deim_gap", "fold_gap")
# what a selection call keeps: S, the singular triplets, the indices
BASE = ("S", "P", "sig", "Q", "p", "q")


class Recorder:
    """Keeps what the program's index selection returned, call by call."""

    def __init__(self):
        self.calls = []
        self._S = None
        self._orig = None

    def install(self):
        from repro_torch.core import compress
        select, score = compress.select_indices, compress.wanda_scores
        self._orig = (compress, select, score)

        def wanda_scores(*a, **k):
            self._S = score(*a, **k)
            return self._S

        def select_indices(W, r, *a, **k):
            self._S = None
            p, q, aux = select(W, r, *a, **k)
            self.calls.append({"shape": tuple(W.shape[-2:]), "r": int(r),
                               "S": self._S, "p": p, "q": q,
                               "P": aux.get("P"), "sig": aux.get("sig"),
                               "Q": aux.get("Q")})
            self._S = None
            return p, q, aux
        compress.select_indices = select_indices
        compress.wanda_scores = wanda_scores
        return self

    def uninstall(self):
        if self._orig:
            compress, select, score = self._orig
            compress.select_indices = select
            compress.wanda_scores = score
            self._orig = None

    def take(self, infos) -> Dict[str, dict]:
        """The calls since the last take, by weight name: the program's
        batched pipeline makes one call a (shape, rank) class, its stack
        in the order of ``infos``."""
        calls, self.calls = self.calls, []
        by_key = {(c["shape"], c["r"]): c for c in calls}
        out: Dict[str, dict] = {}
        seen: Dict[tuple, int] = {}
        for info in infos:
            key = (tuple(info.shape), int(info.rank))
            b = seen[key] = seen.get(key, -1) + 1
            c = by_key.get(key)
            if c is not None and b < c["p"].shape[0]:
                out[info.name] = {k: None if c[k] is None else c[k][b]
                                  for k in BASE}
        return out


class Cell:
    def __init__(self, cell: dict, spec: dict, mix: dict, seed: int,
                 device):
        self.cell, self.spec, self.mix = cell, spec, mix
        self.seed, self.device = seed, device
        self.cfg = common.model_config(spec)
        self.targets = common.cur_targets(spec)
        self.rec = Recorder()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def setup(self, warm: bool = True) -> None:
        from repro_torch.configs.base import CURConfig
        from repro_torch.core import angular, calibrate
        from harness.weights import make_params
        c = self.spec["cur"]
        self.parts = {}
        t = time.perf_counter()
        self.params = make_params(self.cfg, dict(self.spec,
                                                 targets=self.targets),
                                  self.seed, self.device)
        self._sync()
        self.parts["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        rng = traffic.rng_for(self.seed, 2)
        self.calib_tokens = torch.from_numpy(rng.integers(
            0, self.cfg.vocab_size, (c["calib_batch"], c["calib_len"])))
        self.calib = calibrate(self.params, self.cfg,
                               [{"tokens": self.calib_tokens.to(self.device)}])
        dist = angular.layer_distances(self.calib.hidden)
        self.layers = angular.select_layers(dist, c["n_compress_layers"],
                                            c["layer_selection"])
        self.ccfg = CURConfig(
            enabled=True, r_max=c["r_max"], n_compress_layers=1,
            selection=c["selection"], layer_selection=c["layer_selection"],
            svd=self.cell["svd"], fold_u=c["fold_u"],
            seed=int(self.seed) % (2 ** 31))
        self._sync()
        self.parts["calibrate"] = time.perf_counter() - t
        if warm:
            t = time.perf_counter()
            self.rec.install()
            try:
                self._one(self.layers[0])
            finally:
                self.rec.uninstall()
            self._sync()
            self.parts["warm"] = time.perf_counter() - t

    def _one(self, li: int):
        """The program's compress_model on layer li: (its folded leaves by
        weight name, its per-weight records, what its index selection
        returned by weight name)."""
        from repro_torch.core import compress_model
        new, _, info = compress_model(self.params, self.cfg, self.ccfg,
                                      self.calib, layers=[li])
        blk = new["groups"][li][0]
        leaves = {w.name: {k: v[0] for k, v in blk[w.name].items()}
                  for w in info.weights}
        return leaves, info.weights, self.rec.take(info.weights)

    def run_window(self, seconds: float, trace: bool,
                   trace_at: float = 0.3, trace_layers: int = 1) -> None:
        l0 = launches() if self.device.type == "cuda" else {}
        done: Dict[int, tuple] = {}
        spans = []
        traced: Optional[Trace] = None
        order = traffic.layer_stream(self.mix, self.layers)
        self.rec.install()
        try:
            self._sync()
            t0 = time.perf_counter()
            while True:
                li = next(order)
                tracing = (trace and traced is None
                           and self.device.type == "cuda"
                           and time.perf_counter() >= t0 + trace_at * seconds)
                if tracing:
                    traced = Trace().__enter__()
                ts = time.perf_counter()
                for _ in range(trace_layers if tracing else 1):
                    done[li] = self._one(li)
                    self._sync()
                te = time.perf_counter()
                if tracing:
                    traced.__exit__(None, None, None)
                spans.append((li, ts, te, trace_layers if tracing else 1))
                if te - t0 >= seconds:
                    break
        finally:
            self.rec.uninstall()
        self.window = {"t0": t0, "t_end": te, "spans": spans, "done": done,
                       "trace": (traced.summary() if traced else None),
                       "traced_layers": trace_layers if traced else 0,
                       "launches": ({k: v - l0[k] for k, v in
                                     launches().items()} if l0 else {})}

    def end_to_end(self) -> dict:
        w = self.window
        n = sum(s[3] for s in w["spans"])
        return {"cure_layer_s": (w["t_end"] - w["t0"]) / n,
                "attempted": n, "failed": 0, "window_s": w["t_end"] - w["t0"]}

    def layer_data(self) -> dict:
        w = self.window
        return {"spans": w["spans"], "window_s": w["t_end"] - w["t0"],
                "trace": w["trace"], "traced_layers": w["traced_layers"]}


def dense_layer(params, li: int) -> Dict[str, torch.Tensor]:
    """Layer li of the benchmark's dense weights, as float32 tensors."""
    blk = params["groups"][0][0]
    out = {}
    for k, v in blk.items():
        if isinstance(v, dict):           # a norm: {"scale": (L, D)}
            out[k] = v["scale"][li].float()
        else:
            out[k] = v[li].float()
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.float() - b) / torch.linalg.norm(b))


def stage_gaps(cell: Cell, quant: Optional[str] = None) -> dict:
    """The check's numbers over every weight of the window's last pass
    (the widest of each), and the seconds the reference took.
    ``quant="fp8"``: the control, the reference's own CURing of each
    weight a stage at a time in float8 (``reference/cur.py``), judged in
    the program's place."""
    from reference import cur as rcur
    from reference import model as rmodel
    c = cell
    t = time.perf_counter()
    r_max = c.spec["cur"]["r_max"]
    worst = {k: 0.0 for k in NUMBERS + ("svd_orth",)}
    n = 0
    with rmodel.no_tf32(), torch.no_grad():
        act = rcur.calibrate(c.calib_tokens.to(c.device),
                             lambda li: dense_layer(c.params, li),
                             c.params["embed"], dict(c.spec), c.targets)
        gen = torch.Generator(device=c.device)
        gen.manual_seed(int(c.seed) % (2 ** 63))
        for li, (leaves, infos, recs) in sorted(c.window["done"].items()):
            p = dense_layer(c.params, li)
            for info in infos:
                W, a = p[info.name], act[li][info.name]
                r = rcur.rank_for(W.shape[0], W.shape[1], r_max)
                if quant:
                    got = rcur.cur_weight(W, a, r, quant)
                else:
                    rec = recs.get(info.name)
                    if rec is None or rec["S"] is None or rec["P"] is None:
                        continue
                    got = dict(rec, p=info.rows, q=info.cols,
                               CU=leaves[info.name]["CU"],
                               R=leaves[info.name]["R"])
                rows = torch.as_tensor(got["p"], device=c.device)
                cols = torch.as_tensor(got["q"], device=c.device)
                svd, orth = rcur.svd_shortfall(got["S"], got["P"],
                                               got["sig"], got["Q"], gen)
                gaps = {
                    "wanda_gap": _rel(got["S"], rcur.wanda(W, a)),
                    "svd_gap": svd, "svd_orth": orth,
                    "deim_gap": max(rcur.deim(got["P"][:, :r], got["p"])[1],
                                    rcur.deim(got["Q"][:, :r], got["q"])[1]),
                    "fold_gap": (_rel(got["CU"], rcur.fold_at(W, rows, cols))
                                 + _rel(got["R"], W[rows, :])),
                }
                for k, v in gaps.items():
                    worst[k] = max(worst[k], v)
                n += 1
    expected = len(c.window["done"]) * len(c.targets)
    return dict(worst, weights=n, missing=expected - n,
                seconds=time.perf_counter() - t)


def judge(g: dict, limits: dict):
    """(correct, checks): each number beside its limit."""
    checks = {k: {"value": g[k], "limit": limits[k]} for k in NUMBERS}
    checks["weights_missing"] = {"value": g["missing"], "limit": 0}
    correct = (all(g[k] <= limits[k] for k in NUMBERS)
               and g["missing"] == 0 and g["weights"] > 0)
    return correct, checks


def run(cell: dict, spec: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float) -> dict:
    c = Cell(cell, spec, mix, seed, device)
    c.setup()
    setup_s = time.perf_counter() - t_start
    c.run_window(seconds, trace, **cell.get("trace", {}))
    e2e = c.end_to_end()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    g = stage_gaps(c)
    correct, checks = judge(g, cell["limits"])
    return {"correct": correct, "setup_s": setup_s, "e2e": e2e,
            "units": UNITS, "data": c.layer_data(), "memory_peak_bytes": peak,
            "checks": checks, "launches": c.window["launches"],
            "trace": c.window["trace"], "check_s": g["seconds"],
            "svd_orth": g["svd_orth"],
            "setup_parts": c.parts, "layers": c.layers}
