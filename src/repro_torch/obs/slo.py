"""SLO specification + evaluation over served requests.

An :class:`SLOSpec` states per-request latency targets — TTFT (time to
first token, measured from the request's *scheduled* arrival, so queue
wait counts) and TPOT (mean per-token decode latency) — plus the
attainment fraction the service promises ("99% of requests see TTFT
under 500 ms"). Evaluation comes in two shapes:

  - :func:`evaluate` — offline/batch: score a finished request set
    (``Server.finished`` values) against the spec. Reports attainment,
    **goodput** (tokens/s counting only requests that met the SLO — the
    capacity number an operator can actually sell), exact latency
    percentiles, and whether the spec held.
  - :class:`SLOMonitor` — online: feed request completions as they
    happen; sliding-window percentiles (ring-buffer
    :class:`~repro_torch.obs.metrics.Histogram` mode) and windowed attainment
    that recover when an incident ends instead of averaging it away.

:func:`decompose` splits end-to-end latency into queue-wait vs prefill
vs decode from the tracer's per-request span lanes — where an SLO miss
is coming from, not just that it happened.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.metrics import Histogram

DEFAULT_WINDOW = 256

#: terminal ``finish_reason`` values that are failures, not completions.
#: Mirrors ``repro_torch.serving.resilience.FAILURE_REASONS`` (kept literal
#: here so obs never imports the serving stack). A failed request counts
#: against attainment — shedding load must never flatter the denominator.
FAILURE_REASONS = ("rejected", "shed", "timeout", "cancelled")


def _pctl(xs: List[float], p: float) -> float:
    """Nearest-rank percentile (matches ``Histogram.percentile``)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    idx = min(len(xs) - 1, max(0, math.ceil(p / 100.0 * len(xs)) - 1))
    return xs[idx]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-request targets + the promised attainment fraction.

    A request *meets* the SLO when its TTFT and TPOT are both within
    target (``math.inf`` disables a dimension). The service meets the
    SLO when at least ``attainment`` of requests do."""
    ttft_s: float = math.inf
    tpot_s: float = math.inf
    attainment: float = 0.99

    def meets(self, ttft_s: float, tpot_s: float) -> bool:
        return ttft_s <= self.ttft_s and tpot_s <= self.tpot_s

    def to_json(self) -> dict:
        return {"ttft_s": self.ttft_s, "tpot_s": self.tpot_s,
                "attainment": self.attainment}

    @classmethod
    def from_json(cls, d: dict) -> "SLOSpec":
        return cls(**{k: d[k] for k in ("ttft_s", "tpot_s", "attainment")
                      if k in d})


def request_metrics(req) -> Optional[dict]:
    """Per-request latency view of a finished
    :class:`~repro_torch.serving.scheduler.Request`: TTFT from scheduled
    arrival, mean TPOT over the decode phase, end-to-end seconds.
    Returns None for requests without a recorded first token."""
    if req.ttft is None:
        return None
    n = len(req.out_tokens)
    finish = req.finish_time if req.finish_time is not None \
        else req.arrival + req.ttft
    e2e = finish - req.arrival
    decode = max(0.0, e2e - req.ttft)
    return {"rid": req.rid, "ttft_s": req.ttft,
            "tpot_s": decode / (n - 1) if n > 1 else 0.0,
            "e2e_s": e2e, "n_tokens": n}


@dataclasses.dataclass
class SLOReport:
    spec: SLOSpec
    n_requests: int = 0
    n_meeting: int = 0
    n_failed: int = 0
    failures: Dict[str, int] = dataclasses.field(default_factory=dict)
    attainment: float = 0.0
    met: bool = False
    tokens_total: int = 0
    tokens_meeting: int = 0
    elapsed_s: float = 0.0
    throughput_tok_s: float = 0.0
    goodput_tok_s: float = 0.0
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    tpot_p50_s: float = 0.0
    tpot_p99_s: float = 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["spec"] = self.spec.to_json()
        return d


def evaluate(requests: Iterable, spec: SLOSpec,
             elapsed_s: float) -> SLOReport:
    """Score a finished request set against ``spec``.

    ``elapsed_s`` is the serving wall window (drive duration) — the
    denominator for throughput and goodput, so an engine that meets
    latency by rejecting work still scores honestly."""
    rep = SLOReport(spec=spec, elapsed_s=elapsed_s)
    ttfts: List[float] = []
    tpots: List[float] = []
    for req in requests:
        reason = getattr(req, "finish_reason", None)
        if reason in FAILURE_REASONS:
            # failure-status check comes FIRST: a timed-out request may
            # have a recorded TTFT, but it stays a failure — it counts in
            # the denominator and never meets. Its partial tokens count
            # toward throughput (they were generated), never goodput.
            rep.n_requests += 1
            rep.n_failed += 1
            rep.failures[reason] = rep.failures.get(reason, 0) + 1
            rep.tokens_total += len(getattr(req, "out_tokens", ()))
            continue
        m = request_metrics(req)
        if m is None:
            continue
        rep.n_requests += 1
        rep.tokens_total += m["n_tokens"]
        ttfts.append(m["ttft_s"])
        tpots.append(m["tpot_s"])
        if spec.meets(m["ttft_s"], m["tpot_s"]):
            rep.n_meeting += 1
            rep.tokens_meeting += m["n_tokens"]
    if rep.n_requests:
        rep.attainment = rep.n_meeting / rep.n_requests
    rep.met = (rep.n_requests > 0
               and rep.attainment >= spec.attainment)
    if elapsed_s > 0:
        rep.throughput_tok_s = rep.tokens_total / elapsed_s
        rep.goodput_tok_s = rep.tokens_meeting / elapsed_s
    rep.ttft_p50_s = _pctl(ttfts, 50)
    rep.ttft_p99_s = _pctl(ttfts, 99)
    rep.tpot_p50_s = _pctl(tpots, 50)
    rep.tpot_p99_s = _pctl(tpots, 99)
    return rep


class SLOMonitor:
    """Online sliding-window SLO evaluation.

    Feed one :func:`observe` per request completion; ``report()`` gives
    windowed p50/p99 (ring-buffer histograms over the last ``window``
    requests), windowed and cumulative attainment, and cumulative
    goodput tokens. Wire the histograms into a server's registry by
    passing ``registry`` — they export through the normal snapshot /
    Prometheus paths."""

    def __init__(self, spec: SLOSpec, window: int = DEFAULT_WINDOW,
                 registry=None, prefix: str = "repro_slo_"):
        self.spec = spec
        self.window = window
        if registry is not None:
            self._h_ttft = registry.histogram(
                prefix + "ttft_s", "windowed TTFT (s)", window=window)
            self._h_tpot = registry.histogram(
                prefix + "tpot_s", "windowed TPOT (s)", window=window)
        else:
            self._h_ttft = Histogram(prefix + "ttft_s", window=window)
            self._h_tpot = Histogram(prefix + "tpot_s", window=window)
        self._meets: deque = deque(maxlen=window)
        self.n_requests = 0
        self.n_meeting = 0
        self.n_failed = 0
        self.failures: Dict[str, int] = {}
        self.tokens_total = 0
        self.tokens_meeting = 0

    def observe(self, ttft_s: float, tpot_s: float,
                n_tokens: int = 0) -> bool:
        """Record one completion; returns whether it met the SLO."""
        self._h_ttft.observe(ttft_s)
        self._h_tpot.observe(tpot_s)
        ok = self.spec.meets(ttft_s, tpot_s)
        self._meets.append((ok, n_tokens))
        self.n_requests += 1
        self.tokens_total += n_tokens
        if ok:
            self.n_meeting += 1
            self.tokens_meeting += n_tokens
        return ok

    def observe_failure(self, reason: str, n_tokens: int = 0) -> bool:
        """Record a shed/rejected/timed-out/cancelled request: it enters
        the attainment denominator (window and cumulative) as a miss; no
        latency sample is taken (the latency is censored, not zero)."""
        self._meets.append((False, n_tokens))
        self.n_requests += 1
        self.n_failed += 1
        self.failures[reason] = self.failures.get(reason, 0) + 1
        self.tokens_total += n_tokens
        return False

    def observe_request(self, req) -> Optional[bool]:
        reason = getattr(req, "finish_reason", None)
        if reason in FAILURE_REASONS:
            return self.observe_failure(
                reason, len(getattr(req, "out_tokens", ())))
        m = request_metrics(req)
        if m is None:
            return None
        return self.observe(m["ttft_s"], m["tpot_s"], m["n_tokens"])

    def report(self, elapsed_s: Optional[float] = None) -> dict:
        """Windowed + cumulative SLO view. With ``elapsed_s`` the report
        adds goodput-under-shedding: tokens of SLO-meeting requests per
        second of wall time — the rate the shed/failed traffic can never
        inflate."""
        win = list(self._meets)
        n_win = len(win)
        meet_win = sum(1 for ok, _ in win if ok)
        out = {
            "spec": self.spec.to_json(),
            "window": self.window,
            "n_requests": self.n_requests,
            "n_failed": self.n_failed,
            "failures": dict(self.failures),
            "attainment": (self.n_meeting / self.n_requests
                           if self.n_requests else 0.0),
            "attainment_window": meet_win / n_win if n_win else 0.0,
            "met_window": (n_win > 0
                           and meet_win / n_win >= self.spec.attainment),
            "tokens_total": self.tokens_total,
            "tokens_meeting": self.tokens_meeting,
            "ttft_p50_s": self._h_ttft.percentile(50),
            "ttft_p99_s": self._h_ttft.percentile(99),
            "tpot_p50_s": self._h_tpot.percentile(50),
            "tpot_p99_s": self._h_tpot.percentile(99),
        }
        if elapsed_s is not None and elapsed_s > 0:
            out["throughput_tok_s"] = self.tokens_total / elapsed_s
            out["goodput_tok_s"] = self.tokens_meeting / elapsed_s
        return out


# ---------------------------------------------------------------------------
# latency decomposition
# ---------------------------------------------------------------------------

#: tracer span names -> decomposition phases (the per-request lanes the
#: server already records; spec draft/verify fold into decode)
_PHASES = {
    "queued": "queue_wait",
    "restore": "queue_wait",
    "prefill": "prefill",
    "decode_window": "decode",
    "spec_draft": "decode",
    "spec_verify": "decode",
}


def decompose(tracer) -> Dict[str, float]:
    """Queue-wait vs prefill vs decode seconds from a tracer's span
    lanes (``Tracer.durations()`` aggregation), plus each phase's
    fraction of their total — where the latency budget actually goes."""
    durs = tracer.durations()
    out = {"queue_wait_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0}
    for name, phase in _PHASES.items():
        out[phase + "_s"] = out.get(phase + "_s", 0.0) \
            + durs.get(name, 0.0)
    total = out["queue_wait_s"] + out["prefill_s"] + out["decode_s"]
    for phase in ("queue_wait", "prefill", "decode"):
        out[phase + "_frac"] = (out[phase + "_s"] / total
                                if total > 0 else 0.0)
    return out


def decompose_stats(stats: dict) -> Dict[str, float]:
    """The same decomposition from ``Server.stats()`` (no tracer
    needed): queue wait from the submit->prefill histogram sum, prefill
    and decode from the engine phase counters."""
    qw = stats.get("queue_wait_total_s", 0.0)
    pf = stats.get("prefill_time_s", 0.0)
    dc = stats.get("decode_time_s", 0.0)
    total = qw + pf + dc
    return {"queue_wait_s": qw, "prefill_s": pf, "decode_s": dc,
            "queue_wait_frac": qw / total if total > 0 else 0.0,
            "prefill_frac": pf / total if total > 0 else 0.0,
            "decode_frac": dc / total if total > 0 else 0.0}
