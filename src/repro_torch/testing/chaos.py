"""Seeded, deterministic fault injection for the serving stack.

Production systems treat faults as inputs; this module makes them
*reproducible* inputs. A :class:`FaultPlan` is a list of
:class:`FaultSpec` rows plus a seed — every activation decision is a
pure function of ``(seed, fault_index, step_index)``, so the same plan
against the same request stream injects the identical fault sequence,
and a failing chaos run replays bit-for-bit from its JSON spec.

A copy of the JAX package's chaos module (the port imports nothing of
that package): the same plans, the same activation draws and the same
event log, so a plan replays the same faults in either package.
:func:`corrupt_checkpoint` finds a step's files through the port's
checkpoint manager (``repro_torch.dist.checkpoint``), so the manager it
corrupts is the one that must reject the step.

Fault classes and where their hooks live:

  ``latency_spike``    sleeps inside ``Server.step()`` (the chaos
                       ``on_step`` hook) — models a GC pause, a
                       preempted VM, a slow DMA
  ``transient_error``  arms an :class:`InjectedFault` raised at the top
                       of ``Server._run_prefill`` / ``_run_decode``
                       (the ``site`` hook) before any state mutates;
                       the server rolls back admission and retries the
                       step — models a transient device error
  ``pool_squeeze``     takes blocks out of circulation through
                       ``BlockAllocator.squeeze`` (explicit hook in
                       ``paged_cache.py``) — models a co-tenant eating
                       HBM; released when the fault window closes
  ``queue_storm``      submits a burst of seeded junk requests through
                       ``Server.submit`` — models an abusive client or
                       a retry stampede; exercises bounded admission
  ``checkpoint_corruption``  flips a bit in / truncates a checkpoint
                       leaf file (:func:`corrupt_checkpoint`) — models
                       disk rot; exercises the crc32 + keep-N fallback

Every injected fault is recorded as a :class:`FaultEvent` (host list),
an obs counter (``repro_chaos_faults_injected_total`` labeled by kind)
and a tracer instant event — the chaos trace lands in the same
Perfetto/JSONL artifacts the serving metrics do.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np

from repro_torch.dist.checkpoint import step_dirname

FAULT_KINDS = ("latency_spike", "transient_error", "pool_squeeze",
               "queue_storm", "checkpoint_corruption")

_NEVER = 1 << 30


class InjectedFault(RuntimeError):
    """A chaos-injected transient failure. The server treats it as a
    retryable step failure: state is rolled back and the step retried
    on the next engine iteration."""

    def __init__(self, site: str, step: int):
        super().__init__(f"injected transient fault at {site} "
                         f"(step {step})")
        self.site = site
        self.step = step


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault stream: a kind, an active step range ``[start_step,
    end_step)``, a per-step activation probability (seeded Bernoulli),
    and kind-specific magnitude fields.

    ``site`` targets ``transient_error`` (``prefill`` / ``decode`` /
    ``any``). ``magnitude`` is seconds for ``latency_spike`` and the
    free-pool fraction for ``pool_squeeze``. ``n`` is the request count
    for ``queue_storm``."""
    kind: str
    start_step: int = 0
    end_step: int = _NEVER
    probability: float = 1.0
    site: str = "any"
    magnitude: float = 0.0
    n: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(want one of {FAULT_KINDS})")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "FaultSpec":
        return cls(**{k: d[k] for k in
                      ("kind", "start_step", "end_step", "probability",
                       "site", "magnitude", "n") if k in d})


@dataclasses.dataclass
class FaultEvent:
    """One injected fault occurrence (the replayable evidence trail)."""
    step: int
    kind: str
    site: str = ""
    detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class FaultPlan:
    """A seeded list of fault streams, replayable from JSON."""

    def __init__(self, faults: List[FaultSpec], seed: int = 0):
        self.faults = list(faults)
        self.seed = int(seed)

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "faults": [f.to_json() for f in self.faults]}

    @classmethod
    def from_json(cls, d: dict) -> "FaultPlan":
        return cls([FaultSpec.from_json(f) for f in d.get("faults", ())],
                   seed=d.get("seed", 0))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _fires(seed: int, fi: int, step: int, p: float) -> bool:
    """Deterministic per-(fault, step) Bernoulli draw — independent of
    call order, wall clock, and any other fault stream."""
    if p >= 1.0:
        return True
    if p <= 0.0:
        return False
    return np.random.default_rng((seed, fi, step)).random() < p


class ChaosEngine:
    """The hooks object a :class:`~repro_torch.serving.server.Server`
    drives.

    Construct one engine per serving run (it holds per-run state:
    squeezed blocks, armed faults, the event log); the *plan* is the
    reusable artifact. ``bind`` is called by the server so chaos
    counters land on the same obs registry/tracer the serving metrics
    do."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.events: List[FaultEvent] = []
        self._armed: dict = {}          # site -> step (this step only)
        self._squeeze_held = set()      # fault indices holding blocks
        self._m_faults = None
        self._tracer = None

    # -- wiring --------------------------------------------------------
    def bind(self, obs=None, tracer=None) -> "ChaosEngine":
        if obs is not None:
            self._m_faults = obs.counter(
                "repro_chaos_faults_injected_total",
                "chaos faults injected", labels=("kind",))
        self._tracer = tracer
        return self

    def _record(self, step: int, kind: str, site: str = "",
                **detail) -> None:
        self.events.append(FaultEvent(step=step, kind=kind, site=site,
                                      detail=dict(detail)))
        if self._m_faults is not None:
            self._m_faults.labels(kind=kind).inc()
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.event("chaos_" + kind, step=step, site=site,
                               **detail)

    # -- hooks ---------------------------------------------------------
    def on_step(self, server, step: int) -> None:
        """Called at the top of every ``Server.step()``. Applies
        latency spikes, opens/closes pool squeezes, fires queue storms,
        and arms transient errors for this step's site hooks."""
        self._armed = {}
        seed = self.plan.seed
        for fi, f in enumerate(self.plan.faults):
            active = (f.start_step <= step < f.end_step
                      and _fires(seed, fi, step, f.probability))
            if f.kind == "latency_spike":
                if active and f.magnitude > 0:
                    time.sleep(f.magnitude)
                    self._record(step, f.kind, sleep_s=f.magnitude)
            elif f.kind == "transient_error":
                if active:
                    self._armed[f.site or "any"] = step
            elif f.kind == "pool_squeeze":
                alloc = server.scheduler.alloc
                in_window = f.start_step <= step < f.end_step
                if in_window and fi not in self._squeeze_held:
                    n = max(1, int(f.magnitude * alloc.n_free)) \
                        if f.magnitude else f.n
                    got = alloc.squeeze(n)
                    if got:
                        self._squeeze_held.add(fi)
                        self._record(step, f.kind, blocks=got)
                elif not in_window and fi in self._squeeze_held:
                    rel = alloc.release_squeeze()
                    self._squeeze_held.discard(fi)
                    self._record(step, f.kind, released=rel)
            elif f.kind == "queue_storm":
                if active:
                    self._storm(server, step, fi, f)

    def _storm(self, server, step: int, fi: int, f: FaultSpec) -> None:
        rng = np.random.default_rng((self.plan.seed, fi, step, 7))
        vocab = server.cfg.vocab_size
        n = max(1, f.n)
        for _ in range(n):
            # a storm request turned away by bounded admission is the
            # defense working: submit records it as "rejected", never raises
            server.submit(rng.integers(0, vocab, 8).tolist(),
                          max_new_tokens=4)
        self._record(step, f.kind, offered=n, submitted=n)

    def site(self, name: str, step: int) -> None:
        """Raise the armed transient fault for this site (called at the
        top of ``_run_prefill`` / ``_run_decode``, before any scheduler
        or device state mutates)."""
        armed = self._armed.pop(name, None)
        if armed is None:
            armed = self._armed.pop("any", None)
        if armed is not None:
            self._record(step, "transient_error", site=name)
            raise InjectedFault(name, step)

    def finish(self, server) -> None:
        """End-of-run hook: release anything chaos still holds (open
        squeeze windows) so pool-drain invariants are checkable."""
        if self._squeeze_held:
            rel = server.scheduler.alloc.release_squeeze()
            self._record(-1, "pool_squeeze", released=rel, at="finish")
            self._squeeze_held.clear()

    # -- evidence ------------------------------------------------------
    def event_log(self) -> List[dict]:
        return [e.to_json() for e in self.events]

    def save_events(self, path: str) -> str:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e.to_json()) + "\n")
        return path


# ---------------------------------------------------------------------------
# checkpoint corruption (offline fault)
# ---------------------------------------------------------------------------

def corrupt_checkpoint(directory: str, step: int, mode: str = "bitflip",
                       leaf: int = 0, seed: int = 0) -> str:
    """Corrupt one leaf file of checkpoint ``step`` under ``directory``:
    ``bitflip`` XORs one seeded byte, ``truncate`` drops the second
    half of the file. Returns the corrupted path. The crc32 manifest
    check must reject the checkpoint afterwards — that is the test."""
    path = os.path.join(directory, step_dirname(step),
                        f"leaf_{leaf:05d}.npy")
    size = os.path.getsize(path)
    if mode == "bitflip":
        off = int(np.random.default_rng(seed).integers(0, size))
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x40]))
    elif mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path
