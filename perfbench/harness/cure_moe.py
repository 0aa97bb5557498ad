"""CURing cells of a mixture-of-experts stage (K-EXAONE): one user CURing
the attention, the shared expert and every routed expert this chip holds,
a layer at a time.

As ``harness/cure.py``'s cells, with the program's own K-EXAONE
``ModelConfig`` built from the config file (EXAONE 4's block, the
sigmoid router, the held share of experts ``expert_first ..`` of
``router_experts``) and its CUR targets (``cur.targets``: ``wq``,
``wk``, the shared expert's ``w_gate`` and each held routed expert's
``w_gate``, a weight of its own). Set-up: the weights made on the card
from the seed (every CUR target, each expert included, with a decaying
spectrum: ``harness/weights.py``'s ``decaying`` on the (L E, m, n) view),
the program's calibration (each expert's WANDA statistics over the
tokens routed to it), its angular layer selection and one warm layer.
The window then runs ``compress_model`` on one selected layer at a time,
round robin, and ``cure_layer_s`` is its wall seconds over the layers
CURed.

The check holds every weight of the window's last pass (35 a layer: wq,
wk, the shared expert and 32 experts; with the cell's
``follow_experts`` set, every weight of the last layer CURed and, of
the other layers, wq, wk, the shared expert and that many experts drawn
from the seed) against the plain reference (``reference/kexaone.py``,
``reference/cur.py``) with the dense cell's numbers, keyed by weight and
expert: ``wanda_gap``, ``svd_gap``, ``deim_gap``, ``fold_gap``,
``weights_missing``; ``expert_forward_gap``: the program's MoE layer
with its folded experts run on the calibration rows (the reference's
input to that layer, in the configuration's dtype) against the
reference's layer with those C' R weights, over the whole layer's
output, each routing by its own float32 router; and ``routing_gap``:
the program's routing of its calibration rows against the reference
router's on the same rows (the program's MoE inputs, in float32), over
every MoE layer, as the relative difference of their (tokens x
``router_experts``) gate matrices (each token's gates at its experts,
zeros elsewhere), so that a wrong expert set and a wrong gate both
count. The share of rows whose expert set differs is reported beside
it (``routing_rows_differ``, not compared).

``wanda_gap``'s reference is its own float32 calibration, each expert's
statistics over the tokens routed to it. Its forward and its statistics
follow the program's routing of the calibration rows, which the set-up
records, as the SVD and DEIM stages follow the program's own S, P and
Q: the bfloat16 stream's rounding flips near-tied router scores against
the float32 stream's. ``routing_gap`` and ``expert_forward_gap`` hold
the routing itself.

What the timed path's index selection returned is kept for the check
as it comes: views of each class's stacks for the layer just CURed, and
copies of the records the check follows in it, made as they are taken;
once another layer is CURed, the views are let go, so the harness holds
one layer's stacks and not every layer's. The window's caching
allocator counters (retries, device allocations and frees) and its
reserved peak are reported beside the result.

A checkout whose program has no K-EXAONE (no held share of experts, no
sigmoid router) exits at once with code 2.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import math
import sys
import time
from typing import Dict, Optional, Tuple

import torch

from harness import cure, stages, traffic
from harness.cure import _rel
from harness.profile import Trace, launches
from harness.weights import _generator, _map_with_path, decaying
from reference import kexaone
from reference.kexaone import layer_kinds

UNITS = cure.UNITS
NUMBERS = cure.NUMBERS + ("expert_forward_gap", "routing_gap")
EXPERTS = "experts."
# leaf names of the CUR targets' weights: attention's, the dense MLP's,
# the shared expert's and the expert stacks' gates
DECAYING = ("wq", "wk", "w_gate")
ONES = ("scale", "q_norm", "k_norm")


def model_config(spec: dict):
    """The program's ``ModelConfig`` of the stage a config file describes
    (its merged dict). Exits with code 2 where the program cannot run it."""
    from repro_torch.configs.base import (
        ATTN, ATTN_LOCAL, MLP, MOE, BlockSpec, ModelConfig)
    if not spec["norm_topk_prob"] or spec["scoring_func"] != "sigmoid":
        raise ValueError("the cell runs renormalized sigmoid routing")
    L = spec["num_hidden_layers"]
    groups = []
    for li in range(L):
        b = BlockSpec(ATTN_LOCAL if spec["layer_types"][li] ==
                      "sliding_attention" else ATTN,
                      MOE if spec["mlp_layer_types"][li] == "sparse" else MLP)
        if groups and groups[-1][0] == (b,):
            groups[-1] = ((b,), groups[-1][1] + 1)
        else:
            groups.append(((b,), 1))
    try:
        return ModelConfig(
            name=spec["name"], d_model=spec["hidden_size"], n_layers=L,
            n_heads=spec["num_attention_heads"],
            n_kv_heads=spec["num_key_value_heads"],
            head_dim=spec["head_dim"], window=spec["sliding_window"],
            rope_theta=spec["rope_theta"], qk_norm=True,
            rope_on_global=False, block_norm="output",
            d_ff=spec["intermediate_size"],
            moe_d_ff=spec["moe_intermediate_size"],
            n_experts=spec["router_experts"],
            n_experts_per_tok=spec["num_experts_per_tok"],
            n_shared_experts=spec["num_shared_experts"],
            moe_scoring=spec["scoring_func"],
            routed_scaling=spec["routed_scaling_factor"],
            expert_first=spec["expert_first"],
            experts_held=spec["num_experts"],
            vocab_size=spec["vocab_size"], norm_eps=spec["rms_norm_eps"],
            tie_embeddings=spec["tie_word_embeddings"],
            groups=tuple(groups), scan_layers=False, remat=False,
            dtype=spec["torch_dtype"], moe_impl="dense",
            cur_targets=tuple(spec["cur"]["targets"]))
    except TypeError as e:
        print(f"the program cannot run {spec['name']}: {e}", file=sys.stderr)
        raise SystemExit(2)


def make_params(cfg, decay: float, seed: int, device) -> dict:
    """Weights on ``device`` from the seed, in the program's layout: each
    CUR target's stack (all layers, all held experts) of decaying
    spectrum, the other matrices Gaussian scaled by their fan-in, norm
    scales ones, the embedding N(0, 0.02)."""
    from repro_torch.models.model import init_params
    meta = init_params(0, cfg, device="meta")
    gen = _generator(seed, device)

    def fill(path, a):
        name = path[-1]
        if name in ONES:
            return torch.ones(a.shape, dtype=a.dtype, device=device)
        if name == "embed":
            w = torch.randn(a.shape, generator=gen, dtype=a.dtype,
                            device=device)
            return w.mul_(0.02)
        std = 1.0 / math.sqrt(a.shape[-2])
        if name in DECAYING:
            flat = (math.prod(a.shape[:-2]),) + tuple(a.shape[-2:])
            return decaying(flat, decay, std, gen, a.dtype,
                            device).view(a.shape)
        w = torch.randn(a.shape, generator=gen, dtype=a.dtype, device=device)
        return w.mul_(std)

    return _map_with_path(fill, meta, ())


def ref_layer(params, cfg, li: int) -> Dict:
    """Layer li of the program's dense weights in the reference's layout
    (``reference/kexaone.py``), as float32 tensors."""
    from repro_torch.models.model import iter_layer_params
    for lj, spec, p in iter_layer_params(params, cfg):
        if lj == li:
            break
    f = {k: v.float() for k, v in p.items() if torch.is_tensor(v)}
    out = dict(f, norm1=p["norm1"]["scale"].float(),
               norm2=p["norm2"]["scale"].float())
    if "router" in p:
        out["experts"] = {k: out.pop(k) for k in ("w_gate", "w_up",
                                                  "w_down")}
        out["shared"] = {k: v.float() for k, v in p["shared"].items()}
    return out


def _weight(p: Dict, name: str, expert: Optional[int]):
    """A target's float32 weight in a reference layer dict."""
    if expert is not None:
        return p["experts"][name[len(EXPERTS):]][expert]
    head, _, rest = name.partition(".")
    return p[head][rest] if rest else p[head]


def _leaf(blk: Dict, name: str, expert: Optional[int]):
    """A target's compressed leaf in the program's (un-stacked) layer."""
    if expert is not None:
        return {k: v[expert] for k, v in blk[name[len(EXPERTS):]].items()}
    head, _, rest = name.partition(".")
    return blk[head][rest] if rest else blk[head]


def _act(a: Dict, name: str, expert: Optional[int]):
    return a[name] if expert is None else a[name][expert]


class Recorder(cure.Recorder):
    """``cure.Recorder`` keyed by (weight name, expert)."""

    def take(self, infos, keep=()) -> Tuple[Dict[tuple, dict],
                                             Dict[tuple, dict]]:
        """(every weight's record, views of its class's stacks; copies of
        the records of the keys in ``keep``, which hold no stack)."""
        calls, self.calls = self.calls, []
        by_key = {(c["shape"], c["r"]): c for c in calls}
        out: Dict[tuple, dict] = {}
        seen: Dict[tuple, int] = {}
        for info in infos:
            key = (tuple(info.shape), int(info.rank))
            b = seen[key] = seen.get(key, -1) + 1
            c = by_key.get(key)
            if c is not None and b < c["p"].shape[0]:
                out[(info.name, info.expert)] = {
                    k: None if c[k] is None else c[k][b] for k in cure.BASE}
        kept = {key: {k: None if v is None else v.clone()
                      for k, v in rec.items()}
                for key, rec in out.items() if key in keep}
        return out, kept


def range_busy(events, name: str) -> float:
    """Busy device seconds (intervals merged) of the operations whose
    launch call lies inside a host range called ``name`` (any depth)."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges, launch, dev = [], {}, []
    for e in events:
        s0 = e.start_ns()
        s1 = s0 + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((s0, s1, e.correlation_id()))
        elif e.name() == name:
            ranges.append((s0, s1))
        elif stages.LAUNCH.match(e.name()):
            launch[e.correlation_id()] = s0
    ranges = stages._merge(ranges)
    starts = [r[0] for r in ranges]

    def inside(t):
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= ranges[k][1]
    owned = [(s0, s1) for s0, s1, c in dev
             if c in launch and inside(launch[c])]
    return stages._length(stages._merge(owned)) / 1e9


class Cell(cure.Cell):
    def __init__(self, cell: dict, spec: dict, mix: dict, seed: int,
                 device):
        self.cell, self.spec, self.mix = cell, spec, mix
        self.seed, self.device = seed, device
        self.cfg = model_config(spec)
        self.targets = self.cfg.cur_targets
        self.rec = Recorder()

    def setup(self, warm: bool = True) -> None:
        from repro_torch.configs.base import CURConfig
        from repro_torch.core import angular, calibrate
        c = self.spec["cur"]
        self.parts = {}
        t = time.perf_counter()
        self.params = make_params(self.cfg, float(self.spec["target_decay"]),
                                  self.seed, self.device)
        self._sync()
        self.parts["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        rng = traffic.rng_for(self.seed, 2)
        self.calib_tokens = torch.from_numpy(rng.integers(
            0, self.cfg.vocab_size, (c["calib_batch"], c["calib_len"])))
        with self.recording_routing():
            self.calib = calibrate(
                self.params, self.cfg,
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

    @contextlib.contextmanager
    def recording_routing(self):
        """Keeps, in ``self.routing`` {layer: (T, k) experts}, the
        program's routing of its calibration rows: what its router gives
        on each MoE layer's input where its calibration takes the expert
        statistics (the rows its forward routes alike). Beside it, in
        ``self.route_sums`` {layer: [|G - G_ref|^2, |G_ref|^2, the same
        of the control's G, rows whose expert set differs, rows]}, the
        program's gate matrix G against the reference router's on the
        same rows (and the reference's in float8, the control's)."""
        from repro_torch.models import moe
        from repro_torch.models.model import iter_layer_params
        mod = importlib.import_module("repro_torch.core.calibrate")
        orig = mod.expert_act_sq
        layer_of = {lp["router"].data_ptr(): li for li, _, lp in
                    iter_layer_params(self.params, self.cfg)
                    if "router" in lp}
        n = self.spec["router_experts"]
        self.routing, self.route_sums = {}, {}

        def recorded(h, router, cfg):
            xt = h.reshape(-1, h.shape[-1])
            gates, experts = moe.route_cfg(xt, router, cfg)
            li = layer_of[router.data_ptr()]
            prev = self.routing.get(li)
            self.routing[li] = (experts if prev is None
                                else torch.cat([prev, experts]))
            with kexaone.no_tf32():
                g_ref, e_ref = kexaone.route(xt, router, self.spec)
                want = kexaone.gate_matrix(g_ref, e_ref, n)
                ctl = kexaone.gate_matrix(*kexaone.route(
                    xt, router, self.spec, quant="fp8"), n)
            got = kexaone.gate_matrix(gates, experts, n)
            differ = (torch.sort(experts, -1).values
                      != torch.sort(e_ref, -1).values).any(-1)
            sums = [float((got - want).square().sum()),
                    float(want.square().sum()),
                    float((ctl - want).square().sum()),
                    int(differ.sum()), int(differ.numel())]
            acc = self.route_sums.setdefault(li, [0.0] * 5)
            self.route_sums[li] = [a + b for a, b in zip(acc, sums)]
            return orig(h, router, cfg)
        mod.expert_act_sq = recorded
        try:
            yield
        finally:
            mod.expert_act_sq = orig

    def _one(self, li: int):
        """The program's compress_model on layer li: ((its compressed
        leaves by (weight, expert), its per-weight records, what its
        index selection returned by (weight, expert), its compressed
        layer's params), copies of the returns the check follows in the
        layer when it is not the last, by (weight, expert))."""
        from repro_torch.bridge import tree_map
        from repro_torch.core import compress_model
        new, _, info = compress_model(self.params, self.cfg, self.ccfg,
                                      self.calib, layers=[li])
        blk = tree_map(lambda a: a[0], new["groups"][li][0])
        leaves = {(w.name, w.expert): _leaf(blk, w.name, w.expert)
                  for w in info.weights}
        recs, kept = self.rec.take(info.weights,
                                   set(self.followed(li, False)))
        return (leaves, info.weights, recs, blk), kept

    def run_window(self, seconds: float, trace: bool,
                   trace_at: float = 0.3, trace_layers: int = 1) -> None:
        """``cure.Cell.run_window``, its capture also reduced to the busy
        device time launched inside the ``cur.experts`` ranges; once
        another layer follows, a layer's entry keeps only the copies of
        what the check follows there."""
        l0 = launches() if self.device.type == "cuda" else {}
        m0 = alloc_counts(self.device)
        done: Dict[int, tuple] = {}
        kept: Dict[tuple, dict] = {}
        spans = []
        traced: Optional[Trace] = None
        order = traffic.layer_stream(self.mix, self.layers)
        self.rec.install()
        try:
            self._sync()
            t0 = time.perf_counter()
            while True:
                li = next(order)
                if spans:
                    prev = spans[-1][0]
                    leaves, infos, _, blk = done[prev]
                    done[prev] = (leaves, infos, kept, blk)
                tracing = (trace and traced is None
                           and self.device.type == "cuda"
                           and time.perf_counter() >= t0 + trace_at * seconds)
                if tracing:
                    traced = Trace().__enter__()
                ts = time.perf_counter()
                for _ in range(trace_layers if tracing else 1):
                    done[li], kept = self._one(li)
                    self._sync()
                te = time.perf_counter()
                if tracing:
                    traced.__exit__(None, None, None)
                spans.append((li, ts, te, trace_layers if tracing else 1))
                if te - t0 >= seconds:
                    break
        finally:
            self.rec.uninstall()
        summary = None
        if traced is not None:
            summary = traced.summary()
            summary["expert_busy_s"] = range_busy(
                traced.prof.profiler.kineto_results.events(), "cur.experts")
        m1 = alloc_counts(self.device)
        self.window = {"t0": t0, "t_end": te, "spans": spans, "done": done,
                       "trace": summary,
                       "alloc": {k: v - m0.get(k, 0) if k in ALLOC_COUNTS
                                 else v for k, v in m1.items()},
                       "traced_layers": trace_layers if traced else 0,
                       "launches": ({k: v - l0[k] for k, v in
                                     launches().items()} if l0 else {})}

    def followed(self, li: int, last: bool) -> list:
        """The (weight, expert) keys the check follows in layer li (see
        the module docstring): every target of the window's last layer,
        of another layer its experts drawn from the seed and the layer."""
        E = self.cfg.n_local_experts
        k = self.cell.get("follow_experts")
        if not layer_kinds(self.spec, li)[1]:
            return [(t, None) for t in self.targets if "." not in t]
        ids = range(E)
        if k is not None and not last:
            rng = traffic.rng_for(self.seed, 1000 + li)
            ids = sorted(int(i) for i in rng.choice(E, k, replace=False))
        return [(t, None) for t in self.targets
                if not t.startswith(EXPERTS) and t != "w_gate"] + [
            (t, e) for t in self.targets if t.startswith(EXPERTS)
            for e in ids]

    def routing_gaps(self) -> dict:
        """``routing_gap`` (the widest layer's), the control's, and the
        widest layer's share of rows whose expert set differs."""
        s = self.route_sums.values()
        return {
            "routing_gap": max((math.sqrt(a[0] / a[1]) for a in s),
                               default=0.0),
            "routing_gap_fp8": max((math.sqrt(a[2] / a[1]) for a in s),
                                   default=0.0),
            "routing_rows_differ": max((a[3] / a[4] for a in s),
                                       default=0.0)}


# the caching allocator's counters a window reports as its own count
ALLOC_COUNTS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def alloc_counts(device) -> dict:
    """The caching allocator's counters and reserved peak (CUDA only)."""
    if device.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(device)
    out = {k: int(st.get(k, 0)) for k in ALLOC_COUNTS}
    out["reserved_peak_bytes"] = int(st.get("reserved_bytes.all.peak", 0))
    return out


def _forward_gap(c: Cell, blk: Dict, x: torch.Tensor, p: Dict,
                 gates: Dict, quant: Optional[str]) -> float:
    """A MoE layer on rows x (T, D): the program's, with its folded
    layer ``blk`` (or, for the control, the reference in float8), against
    the reference's in float32, both with the gate weights ``gates``
    ((E, D, F) experts, (D, F) shared) in place of the dense ones."""
    from repro_torch.models.model import torch_dtype
    xq = x.to(torch_dtype(c.cfg.dtype))
    ref_p = dict(p, experts=dict(p["experts"], w_gate=gates["experts"]),
                 shared=dict(p["shared"], w_gate=gates["shared"]))
    want = kexaone.moe(xq.float(), ref_p, c.spec)
    if quant:
        got = kexaone.moe(xq.float(), ref_p, c.spec, quant)
    else:
        from repro_torch.models.moe import moe_forward
        got = moe_forward(xq[None], blk, c.cfg)[0]
    return _rel(got, want)


def _dense_gate(w) -> torch.Tensor:
    """A gate weight in float32: C' R of a folded leaf, or the dense one
    the program left."""
    if isinstance(w, dict):
        return w["CU"].float() @ w["R"].float()
    return w.float()


def stage_gaps(c: Cell, quant: Optional[str] = None) -> dict:
    """The check's numbers over the followed weights of the window's last
    pass (the widest of each), and the seconds the reference took.
    ``quant="fp8"``: the control, the reference's own CURing of each
    weight a stage at a time in float8, judged in the program's place
    (and its MoE layer computed in float8)."""
    from reference import cur as rcur
    t = time.perf_counter()
    r_max = c.spec["cur"]["r_max"]
    worst = {k: 0.0 for k in NUMBERS + ("svd_orth",)}
    worst["routing_gap"] = c.routing_gaps()[
        "routing_gap_fp8" if quant else "routing_gap"]
    n = 0
    done = c.window["done"]
    last = c.window["spans"][-1][0]
    follow = {li: c.followed(li, li == last) for li in done}
    sparse = [li for li in done if layer_kinds(c.spec, li)[1]]
    with kexaone.no_tf32(), torch.no_grad():
        act, routed, kept = kexaone.calibrate(
            c.calib_tokens.to(c.device),
            lambda li: ref_layer(c.params, c.cfg, li), c.params["embed"],
            c.spec, c.targets, keep=sparse, routing=c.routing)
        gen = torch.Generator(device=c.device)
        gen.manual_seed(int(c.seed) % (2 ** 63))
        for li, (leaves, infos, recs, blk) in sorted(done.items()):
            p = ref_layer(c.params, c.cfg, li)
            by_key = {(w.name, w.expert): w for w in infos}
            control = {}
            for key in follow[li]:
                info = by_key.get(key)
                if info is None:
                    continue
                W = _weight(p, *key)
                a = _act(act[li], *key)
                r = rcur.rank_for(W.shape[0], W.shape[1], r_max)
                if quant:
                    got = rcur.cur_weight(W, a, r, quant)
                    control[key] = got
                else:
                    rec = recs.get(key)
                    if rec is None or rec["S"] is None or rec["P"] is None:
                        continue
                    got = dict(rec, p=info.rows, q=info.cols,
                               CU=leaves[key]["CU"], R=leaves[key]["R"])
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
            if li not in kept:
                continue
            if quant:
                # the control's C' R where it CURed a weight, else dense
                ex = p["experts"]["w_gate"].clone()
                for (name, e), got in control.items():
                    if e is not None:
                        ex[e] = got["CU"] @ got["R"]
                sh = control.get(("shared.w_gate", None))
                gates = {"experts": ex,
                         "shared": (p["shared"]["w_gate"] if sh is None
                                    else sh["CU"] @ sh["R"])}
            else:
                gates = {"experts": _dense_gate(blk["w_gate"]),
                         "shared": _dense_gate(blk["shared"]["w_gate"])}
            worst["expert_forward_gap"] = max(
                worst["expert_forward_gap"],
                _forward_gap(c, blk, kept[li], p, gates, quant))
            del gates
    expected = sum(len(v) for v in follow.values())
    return dict(worst, weights=n, missing=expected - n,
                seconds=time.perf_counter() - t,
                routing_rows_differ=c.routing_gaps()["routing_rows_differ"],
                routed_min=min((int(v.min()) for v in routed.values()),
                               default=0))


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
            "svd_orth": g["svd_orth"], "weights_checked": g["weights"],
            "routed_min": g["routed_min"],
            "routing_rows_differ": g["routing_rows_differ"],
            "alloc": c.window["alloc"],
            "setup_parts": c.parts, "layers": c.layers,
            "memory_peak_check_bytes": (
                torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)}
