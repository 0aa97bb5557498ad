"""Synthetic workload generation + the open-loop load runner.

The serving benchmarks so far measured hand-rolled fixed workloads
(burst or evenly staggered arrivals). Answering capacity questions —
"what QPS does this config sustain at a TTFT p99 SLO?" — needs offered
load that looks like traffic: random arrival processes at a controlled
rate, mixed prompt/generation lengths, shared prompt prefixes (system
prompts, few-shot templates). Everything here is **seeded and
deterministic**: the same :class:`WorkloadSpec` always generates the
identical request stream, so sweeps are reproducible and two configs
compared at the same offered rate serve byte-identical workloads.

Pieces:

  - :class:`LengthDist` — fixed / choice / lognormal length sampling
    (prompt lengths and generation budgets);
  - :class:`WorkloadSpec` — arrival process (``poisson`` / ``gamma`` /
    ``bursty`` / ``uniform``) at a mean ``rate_qps``, length dists,
    shared-prefix mix, vocab, seed; :func:`generate` turns it into a
    list of plain request dicts (the format ``launch.serve``'s runner
    and the benchmarks already use);
  - :func:`save_trace` / :func:`load_trace` — JSONL traces, so recorded
    or hand-edited workloads replay exactly;
  - :func:`drive` — the **open-loop** runner: submits each request at
    its scheduled virtual arrival time while stepping the
    :class:`~repro_torch.serving.server.Server` in between. Open-loop means
    arrivals never wait for completions; when the engine runs behind,
    late-injected requests keep their *scheduled* arrival stamp, so the
    lateness is counted as queue wait (TTFT measured from intended
    arrival) instead of being silently rebased — the difference between
    measuring the server and flattering it.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, List, Optional

import numpy as np

ARRIVALS = ("poisson", "gamma", "bursty", "uniform", "burst")


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Integer length distribution, clamped to [lo, hi].

    kinds: ``fixed`` (always ``mean``), ``choice`` (uniform or weighted
    over ``values``), ``lognormal`` (mean ``mean``, coefficient of
    variation ``cv`` — the long-tail shape real prompt lengths have).
    """
    kind: str = "choice"
    values: tuple = (8, 12, 16, 24, 32, 40)
    weights: Optional[tuple] = None
    mean: float = 32.0
    cv: float = 0.5
    lo: int = 1
    hi: int = 4096

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "fixed":
            xs = np.full(n, self.mean)
        elif self.kind == "choice":
            p = None
            if self.weights is not None:
                w = np.asarray(self.weights, float)
                p = w / w.sum()
            xs = rng.choice(np.asarray(self.values), size=n, p=p)
        elif self.kind == "lognormal":
            # parameterize by (mean, cv): sigma^2 = ln(1 + cv^2),
            # mu = ln(mean) - sigma^2 / 2 gives E[X] = mean exactly
            sigma2 = np.log1p(self.cv ** 2)
            mu = np.log(self.mean) - sigma2 / 2
            xs = rng.lognormal(mu, np.sqrt(sigma2), size=n)
        else:
            raise ValueError(f"unknown length dist kind {self.kind!r}")
        return np.clip(np.rint(xs).astype(np.int64), self.lo, self.hi)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "LengthDist":
        d = dict(d)
        for k in ("values", "weights"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Seeded synthetic workload: arrival process + length mixes.

    ``arrival``:
      - ``poisson``  exponential interarrivals at ``rate_qps`` (the
        memoryless open-loop default);
      - ``gamma``    gamma interarrivals with coefficient of variation
        ``gamma_cv`` (cv > 1: burstier than Poisson; cv < 1: smoother);
      - ``bursty``   groups of ``burst_size`` simultaneous arrivals,
        bursts spaced so the long-run mean is still ``rate_qps``;
      - ``uniform``  evenly spaced (deterministic pacing);
      - ``burst``    everything at t=0 (pure-throughput / capacity
        calibration).

    ``shared_prefix_fraction`` of requests prepend one of
    ``n_prefixes`` fixed ``prefix_len``-token prefixes (drawn per
    request), modelling system prompts / few-shot templates — the
    workload shape prefix-cache routing and the pool's CoW fork path
    are judged against.
    """
    n_requests: int = 64
    rate_qps: float = 8.0
    arrival: str = "poisson"
    gamma_cv: float = 2.0
    burst_size: int = 8
    prompt: LengthDist = dataclasses.field(default_factory=LengthDist)
    gen: LengthDist = dataclasses.field(
        default_factory=lambda: LengthDist(kind="choice",
                                           values=(4, 8, 16, 24, 32)))
    vocab_size: int = 256
    shared_prefix_fraction: float = 0.0
    n_prefixes: int = 4
    prefix_len: int = 16
    seed: int = 0

    def arrival_times(self, rng: np.random.Generator) -> np.ndarray:
        n, rate = self.n_requests, self.rate_qps
        if self.arrival == "burst" or rate <= 0:
            return np.zeros(n)
        if self.arrival == "uniform":
            return np.arange(n) / rate
        if self.arrival == "poisson":
            return np.cumsum(rng.exponential(1.0 / rate, size=n))
        if self.arrival == "gamma":
            # interarrival mean 1/rate, cv -> shape k = 1/cv^2
            k = 1.0 / (self.gamma_cv ** 2)
            return np.cumsum(rng.gamma(k, 1.0 / (rate * k), size=n))
        if self.arrival == "bursty":
            b = max(1, self.burst_size)
            # burst index i arrives at i * b / rate: within a burst all
            # requests land together, preserving the mean rate
            return np.arange(n) // b * (b / rate)
        raise ValueError(f"unknown arrival process {self.arrival!r}")

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["prompt"] = self.prompt.to_json()
        d["gen"] = self.gen.to_json()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "WorkloadSpec":
        d = dict(d)
        for k in ("prompt", "gen"):
            if isinstance(d.get(k), dict):
                d[k] = LengthDist.from_json(d[k])
        return cls(**d)


def generate(spec: WorkloadSpec) -> List[dict]:
    """Materialize the request stream: list of
    ``{"prompt", "max_new_tokens", "arrival_offset_s", "prefix_id"}``
    dicts sorted by arrival. Deterministic in ``spec`` (one
    ``np.random.default_rng(seed)`` drives every draw in a fixed
    order)."""
    rng = np.random.default_rng(spec.seed)
    arrivals = spec.arrival_times(rng)
    plens = spec.prompt.sample(rng, spec.n_requests)
    gens = spec.gen.sample(rng, spec.n_requests)
    prefixes = [rng.integers(0, spec.vocab_size, spec.prefix_len).tolist()
                for _ in range(max(1, spec.n_prefixes))]
    shared = rng.random(spec.n_requests) < spec.shared_prefix_fraction
    prefix_ids = rng.integers(0, max(1, spec.n_prefixes),
                              spec.n_requests)
    reqs = []
    for i in range(spec.n_requests):
        plen = int(plens[i])
        if shared[i]:
            pre = prefixes[int(prefix_ids[i])]
            tail = max(1, plen - len(pre))
            prompt = pre + rng.integers(
                0, spec.vocab_size, tail).tolist()
        else:
            prompt = rng.integers(0, spec.vocab_size, plen).tolist()
        reqs.append({
            "prompt": prompt,
            "max_new_tokens": int(gens[i]),
            "arrival_offset_s": float(arrivals[i]),
            "prefix_id": int(prefix_ids[i]) if shared[i] else -1,
        })
    reqs.sort(key=lambda r: r["arrival_offset_s"])
    return reqs


# ---------------------------------------------------------------------------
# JSONL trace replay
# ---------------------------------------------------------------------------

def save_trace(path: str, requests: List[dict],
               spec: Optional[WorkloadSpec] = None) -> str:
    """One JSON object per line; an optional ``{"kind": "spec"}``
    header records the generating spec for provenance."""
    with open(path, "w") as f:
        if spec is not None:
            f.write(json.dumps({"kind": "spec", **spec.to_json()}) + "\n")
        for r in requests:
            f.write(json.dumps({"kind": "request", **r}) + "\n")
    return path


def load_trace(path: str) -> List[dict]:
    """Replay a JSONL trace: returns the request list (spec headers and
    unknown kinds skipped), sorted by arrival."""
    reqs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("kind", "request") != "request":
                continue
            d.pop("kind", None)
            reqs.append({"prompt": [int(t) for t in d["prompt"]],
                         "max_new_tokens": int(d["max_new_tokens"]),
                         "arrival_offset_s":
                             float(d.get("arrival_offset_s", 0.0)),
                         "prefix_id": int(d.get("prefix_id", -1))})
    reqs.sort(key=lambda r: r["arrival_offset_s"])
    return reqs


# ---------------------------------------------------------------------------
# open-loop runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DriveReport:
    """What the runner itself observed (the server's stats are separate).

    ``n_late`` / ``max_late_s``: requests whose injection ran behind
    their scheduled arrival because an engine step straddled it. They
    are still stamped with the scheduled arrival — the lateness lands in
    queue wait / TTFT, never silently rebased — so a large ``max_late_s``
    flags that offered load outran the engine's step granularity, not a
    measurement gap."""
    offered: int = 0
    duration_s: float = 0.0
    offered_qps: float = 0.0
    n_late: int = 0
    max_late_s: float = 0.0


def drive(server, requests: List[dict], *, temperature: float = 0.0,
          eos_id: Optional[int] = None, seed_base: int = 0,
          on_submit: Optional[Callable[[int, dict], None]] = None
          ) -> DriveReport:
    """Step ``server`` against the request stream's virtual-time
    arrivals until everything drains. Requests must carry
    ``arrival_offset_s`` (seconds from drive start). Returns a
    :class:`DriveReport`; read latency/SLO results off
    ``server.stats()`` / ``server.finished``."""
    from repro_torch.serving.sampling import SamplingParams

    pending = sorted(requests, key=lambda r: r["arrival_offset_s"])
    t0 = time.perf_counter()
    rep = DriveReport(offered=len(pending))
    i = 0
    while i < len(pending) or not server.idle:
        now = time.perf_counter()
        while (i < len(pending)
               and t0 + pending[i]["arrival_offset_s"] <= now):
            r = pending[i]
            sched = t0 + r["arrival_offset_s"]
            late = now - sched
            if late > 1e-3:
                rep.n_late += 1
                rep.max_late_s = max(rep.max_late_s, late)
            rid = server.submit(r["prompt"], r["max_new_tokens"],
                                sampling=SamplingParams(
                                    temperature=temperature,
                                    seed=seed_base + i),
                                eos_id=eos_id,
                                # scheduled (virtual) arrival, not
                                # submission wall time: lateness counts
                                # as queue wait
                                arrival=sched)
            if on_submit is not None:
                on_submit(rid, r)
            i += 1
        if not server.step() and i < len(pending):
            # engine idle but arrivals outstanding: sleep to the next
            time.sleep(max(0.0, t0 + pending[i]["arrival_offset_s"]
                           - time.perf_counter()))
    rep.duration_s = time.perf_counter() - t0
    rep.offered_qps = (rep.offered / rep.duration_s
                       if rep.duration_s > 0 else 0.0)
    return rep
