"""Resilience layer for the serving runtime: survival under pressure.

The runtime so far assumed a well-behaved world — an unbounded admission
queue, requests that never expire, a pool that always recovers, steps
that always return. Production traffic violates every one of those, so
this module gives :class:`~repro_torch.serving.server.Server` explicit
survival behaviors, all host-side and deterministic:

  - **Bounded admission** (:class:`ResilienceConfig.max_queue` +
    ``overload_policy``): a full queue either rejects the newcomer
    (typed :class:`QueueFull`, surfaced as a terminal ``"rejected"``
    request status), sheds the oldest queued request, or sheds by
    priority class (lowest ``Request.priority`` first). Shedding is a
    deliberate trade — in the same spirit the source paper trades a
    little fidelity for a lot of capacity — instead of an OOM or a
    silent SLO collapse.
  - **Deadlines** (TTFT + total, per request or config defaults) with
    true cancellation: expired requests are cancelled at admission,
    post-prefill, and after every decode window; cancellation frees the
    slot's pool blocks and emits a terminal ``"timeout"`` status.
  - **Graceful degradation**: a reversible :class:`DegradationLadder`
    driven by queue/pool pressure — step 1 disables speculative
    decoding, step 2 shrinks the decode scan window, step 3 sheds per
    the overload policy. Each step has hysteresis so the server doesn't
    flap at a threshold, and every transition is an obs metric/trace
    event.
  - **Liveness**: ``Server.health()`` liveness/readiness probe plus a
    stuck-step watchdog — a wall-clock bound per engine step that
    raises a typed :class:`ServerWedged` carrying a diagnostic
    snapshot.

The failure statuses introduced here (``rejected`` / ``shed`` /
``timeout`` / ``cancelled``) are first-class: ``repro_torch.obs.slo`` counts
them against SLO attainment, so load-shedding can never flatter the
denominator.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

OVERLOAD_POLICIES = ("reject", "shed-oldest", "priority")

#: terminal ``Request.finish_reason`` values that are failures, not
#: completions — SLO evaluation counts these against attainment
FAILURE_REASONS = ("rejected", "shed", "timeout", "cancelled")

#: decode scan-window cap while the ladder is at the window-shrink step
DEGRADED_DECODE_WINDOW = 2


class QueueFull(RuntimeError):
    """Bounded admission queue at capacity under the ``reject`` policy
    (or ``priority`` with no lower-priority victim to shed)."""

    def __init__(self, rid: int, depth: int, max_queue: int):
        super().__init__(
            f"request {rid}: admission queue full "
            f"({depth}/{max_queue})")
        self.rid = rid
        self.depth = depth
        self.max_queue = max_queue


class ServerWedged(RuntimeError):
    """An engine step exceeded the watchdog's wall-clock bound. Carries
    a diagnostic ``snapshot`` dict (step kind/duration, queue depth,
    pool occupancy, degradation level) for the post-mortem."""

    def __init__(self, message: str, snapshot: dict):
        super().__init__(message)
        self.snapshot = snapshot


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Survival-behavior knobs for one :class:`Server`.

    ``max_queue == 0`` keeps the legacy unbounded queue; deadlines of
    ``0`` disable that check; ``watchdog_s == 0`` disables the stuck-
    step watchdog. ``ladder_enter`` are the pressure thresholds (in
    [0, 1], non-decreasing) at which degradation steps 1..3 engage;
    a step disengages once pressure falls ``ladder_exit_margin`` below
    its enter threshold (hysteresis)."""
    max_queue: int = 0
    overload_policy: str = "reject"
    ttft_deadline_s: float = 0.0      # per-request default; 0 = none
    deadline_s: float = 0.0           # total (arrival -> finish); 0 = none
    watchdog_s: float = 0.0           # wall-clock bound per step; 0 = off
    ladder_enter: Tuple[float, float, float] = (0.70, 0.85, 0.95)
    ladder_exit_margin: float = 0.15

    def __post_init__(self):
        if self.overload_policy not in OVERLOAD_POLICIES:
            raise ValueError(
                f"overload_policy {self.overload_policy!r} not in "
                f"{OVERLOAD_POLICIES}")
        if list(self.ladder_enter) != sorted(self.ladder_enter):
            raise ValueError(
                f"ladder_enter must be non-decreasing: "
                f"{self.ladder_enter}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ResilienceConfig":
        d = dict(d)
        if "ladder_enter" in d:
            d["ladder_enter"] = tuple(d["ladder_enter"])
        return cls(**d)


#: ladder step index -> what it does (step 0 is "normal")
LADDER_ACTIONS = ("normal", "spec_off", "window_shrink", "shed")


class DegradationLadder:
    """Pressure-driven, reversible degradation with hysteresis.

    ``update(pressure)`` moves the level toward the highest rung whose
    enter threshold the pressure clears; dropping a rung additionally
    requires pressure below ``enter - exit_margin``, so the ladder never
    flaps around a threshold. Every transition is recorded (host list +
    obs counter/gauge + tracer event) with the step index and pressure
    that caused it."""

    def __init__(self, cfg: ResilienceConfig, obs=None, tracer=None):
        self.enter = tuple(cfg.ladder_enter)
        self.exit_margin = cfg.ladder_exit_margin
        self.level = 0
        self.transitions: List[dict] = []
        self.tracer = tracer
        if obs is None:
            from repro_torch.obs.metrics import NULL
            self._m_level = self._m_trans = NULL
        else:
            self._m_level = obs.gauge(
                "repro_serving_degradation_level",
                "current degradation-ladder rung (0 = normal)")
            self._m_trans = obs.counter(
                "repro_serving_degradation_transitions_total",
                "degradation-ladder level changes")

    def _raw(self, pressure: float) -> int:
        lvl = 0
        for i, thr in enumerate(self.enter):
            if pressure >= thr:
                lvl = i + 1
        return lvl

    def update(self, pressure: float, step_idx: int = 0) -> int:
        old = self.level
        raw = self._raw(pressure)
        if raw > self.level:
            self.level = raw
        elif (self.level > 0 and raw < self.level
              and pressure < self.enter[self.level - 1]
              - self.exit_margin):
            # recovery is gradual: at most one rung per update, each
            # gated by its hysteresis band — pressure must fall a margin
            # below the rung's enter threshold before it disengages
            self.level -= 1
        if self.level != old:
            rec = {"step": step_idx, "from": old, "to": self.level,
                   "pressure": round(float(pressure), 4),
                   "action": LADDER_ACTIONS[self.level]}
            self.transitions.append(rec)
            self._m_trans.inc()
            self._m_level.set(self.level)
            if self.tracer is not None and self.tracer.enabled:
                self.tracer.event("degrade", **rec)
        return self.level

    # -- what each rung means to the engine ----------------------------
    @property
    def spec_allowed(self) -> bool:
        return self.level < 1

    def decode_window_cap(self, base: int) -> int:
        if self.level >= 2:
            return min(base, DEGRADED_DECODE_WINDOW)
        return base

    @property
    def shed_active(self) -> bool:
        return self.level >= 3

    @property
    def shed_exit_pressure(self) -> float:
        """Pressure the shed step drives the queue back under."""
        return self.enter[2] - self.exit_margin


def deadline_expired(req, now: float) -> Optional[str]:
    """Why ``req`` can no longer be served usefully at time ``now`` —
    ``"timeout"``, or None while it is still viable. A request whose
    TTFT deadline passed before its first token can never deliver a
    useful first token; one whose total deadline passed is dead either
    way."""
    dl = req.deadline_s
    if dl and now - req.arrival > dl:
        return "timeout"
    tdl = req.ttft_deadline_s
    if tdl and req.ttft is None and now - req.arrival > tdl:
        return "timeout"
    return None


def ttft_missed(req) -> bool:
    """Post-prefill check: the first token arrived after its deadline."""
    tdl = req.ttft_deadline_s
    return bool(tdl) and req.ttft is not None and req.ttft > tdl


def pressure_signals(scheduler, max_queue: int,
                     max_concurrency: int) -> dict:
    """Queue/pool pressure in [0, ~]: the ladder's drive signal.

    Queue pressure is depth over capacity when bounded; unbounded
    queues normalize against ``8 x max_concurrency`` (an unbounded
    queue deeper than 8 full batches is pressure however you slice
    it). Pool pressure is live blocks over the pool size, but a busy
    pool is healthy — it only drives the combined signal when the pool
    is *starving admission*: a concurrency slot sits free while the
    head-of-queue request cannot cover its prefill from the free list.
    Without the starvation gate any well-packed pool (e.g. a dense
    decode batch sized to its pool) reads as overload and the ladder
    wrongly strips speculation from a perfectly healthy server."""
    ref = max_queue if max_queue > 0 else 8 * max_concurrency
    qf = scheduler.queue_depth / max(1, ref)
    alloc = scheduler.alloc
    pf = alloc.used / max(1, alloc.n_blocks)
    starved = bool(
        scheduler.queue
        and len(scheduler.active_slots) < scheduler.max_concurrency
        and scheduler.admission_blocks_needed(scheduler.queue[0])
        > alloc.n_free)
    return {"queue": qf, "pool": pf, "starved": starved,
            "pressure": min(1.0, max(qf, pf if starved else 0.0))}
