"""Process-wide metrics registry: counters, gauges, labeled histograms.

Design constraints (the serving hot path steps in ~1 ms on the smoke
models, so every recording must be a handful of host ops):

  - **Histograms** keep fixed log-spaced bucket counts (Prometheus-style
    cumulative exposition) *plus* a bounded reservoir of raw samples, so
    p50/p90/p99 are exact until the reservoir fills and an unbiased
    uniform sample afterwards. No numpy in the record path.
  - **Labels** are a guarded dict of child instruments: the first
    ``labels()`` call per label-set allocates the child, later calls are
    one dict lookup. Cardinality is capped (``MAX_LABEL_SETS``) — an
    unbounded label value (request id, block id) is a bug and raises
    instead of silently eating memory.
  - **Disabled mode** allocates nothing per call: a disabled
    :class:`Registry` hands out the shared :data:`NULL` instrument whose
    methods are constant no-ops, so ``reg.counter("x").inc()`` costs two
    attribute lookups and nothing else.

One process-wide default registry (:func:`default_registry`) backs the
module-level helpers; subsystems that need isolated numbers (each
``serving.Server`` owns its request/latency state) construct their own
always-enabled ``Registry`` and merge into exports via ``snapshot()``.
"""
from __future__ import annotations

import bisect
import math
import random
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

MAX_LABEL_SETS = 64          # per labeled instrument
RESERVOIR_SIZE = 2048        # exact percentiles up to this many samples


def log_buckets(lo: float = 1e-5, hi: float = 100.0,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds covering [lo, hi] (seconds by
    convention), ``per_decade`` buckets per decade."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * (hi / lo) ** (i / n) for i in range(n + 1))


DEFAULT_BUCKETS = log_buckets()


class _Null:
    """Shared do-nothing instrument: every method is a constant no-op and
    ``labels()`` returns the singleton itself, so disabled-mode call
    sites allocate nothing."""
    __slots__ = ()

    def inc(self, n=1):
        return None

    def dec(self, n=1):
        return None

    def set(self, v):
        return None

    def observe(self, v):
        return None

    def labels(self, **kw):
        return self

    @property
    def value(self):
        return 0.0


NULL = _Null()


class Counter:
    """Monotonically increasing count."""
    __slots__ = ("name", "help", "_v")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        self._v += n

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._v}


class Gauge:
    """Point-in-time value (set/inc/dec)."""
    __slots__ = ("name", "help", "_v")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    def inc(self, n: float = 1) -> None:
        self._v += n

    def dec(self, n: float = 1) -> None:
        self._v -= n

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._v}


class Histogram:
    """Fixed-bucket histogram + bounded reservoir for exact percentiles.

    ``observe`` is O(log buckets) (bisect) plus an O(1) reservoir
    update. Percentiles come from the reservoir: exact while
    ``count <= reservoir_size``, an unbiased uniform subsample after
    (Vitter's algorithm R, seeded per instrument for reproducibility).

    ``window > 0`` switches the percentile source to a ring buffer of
    the last ``window`` observations — sliding-window percentiles for
    online SLO evaluation (a p99 that recovers when the incident ends,
    instead of averaging it away). Bucket counts, sum, count, min and
    max stay cumulative in both modes, so the Prometheus exposition is
    identical; only the percentile basis changes.
    """
    __slots__ = ("name", "help", "buckets", "bucket_counts", "_sum",
                 "_count", "_min", "_max", "_reservoir", "_rsize", "_rng",
                 "window", "_ring", "_ring_i")
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 reservoir_size: int = RESERVOIR_SIZE,
                 window: int = 0):
        self.name = name
        self.help = help
        bs = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name}: buckets must be "
                             f"strictly increasing")
        self.buckets = bs
        self.bucket_counts = [0] * (len(bs) + 1)   # +1: +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._reservoir: List[float] = []
        self._rsize = reservoir_size
        self._rng = random.Random(hash(name) & 0xFFFFFFFF)
        if window < 0:
            raise ValueError(f"histogram {name}: window must be >= 0")
        self.window = int(window)
        self._ring: List[float] = []
        self._ring_i = 0

    def observe(self, v: float) -> None:
        self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
        self._sum += v
        self._count += 1
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if self.window:
            if len(self._ring) < self.window:
                self._ring.append(v)
            else:
                self._ring[self._ring_i] = v
                self._ring_i = (self._ring_i + 1) % self.window
            return
        if len(self._reservoir) < self._rsize:
            self._reservoir.append(v)
        else:
            j = self._rng.randrange(self._count)
            if j < self._rsize:
                self._reservoir[j] = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def _samples(self) -> List[float]:
        """Percentile basis: the ring (windowed) or the reservoir."""
        return self._ring if self.window else self._reservoir

    def percentile(self, p: float) -> float:
        """p in [0, 100]; 0.0 when empty (nearest-rank on the samples)."""
        xs = self._samples()
        if not xs:
            return 0.0
        xs = sorted(xs)
        idx = min(len(xs) - 1, max(0, math.ceil(p / 100.0 * len(xs)) - 1))
        return xs[idx]

    def percentiles(self, ps: Iterable[float] = (50, 90, 99)) -> dict:
        xs = sorted(self._samples())
        out = {}
        for p in ps:
            if not xs:
                out[f"p{p:g}"] = 0.0
            else:
                idx = min(len(xs) - 1,
                          max(0, math.ceil(p / 100.0 * len(xs)) - 1))
                out[f"p{p:g}"] = xs[idx]
        return out

    def snapshot(self) -> dict:
        snap = {"type": "windowed_histogram" if self.window
                else "histogram",
                "count": self._count,
                "sum": self._sum, "mean": self.mean,
                "min": self.min, "max": self.max,
                "buckets": list(self.buckets),
                "bucket_counts": list(self.bucket_counts),
                **self.percentiles()}
        if self.window:
            snap["window"] = self.window
            snap["window_count"] = len(self._ring)
        return snap


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Labeled:
    """Parent handle for a labeled instrument family. ``labels(**kw)``
    returns (allocating on first use) the child for that label set.

    ``overflow`` past :data:`MAX_LABEL_SETS` distinct label sets either
    raises (default — an unbounded label value is a bug) or, with
    ``overflow="drop"``, returns :data:`NULL` so open-ended-but-usually-
    small label spaces (compression shape-classes) degrade gracefully.
    """
    kind = "labeled"

    def __init__(self, name: str, kind: str, help: str = "",
                 label_names: Sequence[str] = (),
                 overflow: str = "raise", **kw):
        self.name = name
        self.child_kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self.overflow = overflow
        self._kw = kw
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **kw):
        key = tuple(str(kw[n]) for n in self.label_names)
        if len(kw) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(kw)}")
        child = self._children.get(key)
        if child is None:
            if len(self._children) >= MAX_LABEL_SETS:
                if self.overflow == "drop":
                    return NULL
                raise ValueError(
                    f"{self.name}: label cardinality cap "
                    f"({MAX_LABEL_SETS}) exceeded — a label value is "
                    f"probably unbounded (request id, block id, ...)")
            child = _KINDS[self.child_kind](self.name, self.help,
                                            **self._kw)
            self._children[key] = child
        return child

    def snapshot(self) -> dict:
        return {"type": f"labeled_{self.child_kind}",
                "label_names": list(self.label_names),
                "children": {
                    ",".join(f"{n}={v}" for n, v in
                             zip(self.label_names, key)): c.snapshot()
                    for key, c in sorted(self._children.items())}}


class Registry:
    """Name -> instrument map. Getters are idempotent (same name returns
    the same instrument; a kind mismatch raises). A disabled registry
    hands out :data:`NULL` and records nothing."""

    def __init__(self, enabled: bool = True, prefix: str = ""):
        self.enabled = enabled
        self.prefix = prefix
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _get(self, name: str, kind: str, help: str,
             labels: Sequence[str], overflow: str = "raise", **kw):
        if not self.enabled:
            return NULL
        name = self.prefix + name
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                if labels:
                    inst = Labeled(name, kind, help, labels,
                                   overflow=overflow, **kw)
                else:
                    inst = _KINDS[kind](name, help, **kw)
                self._instruments[name] = inst
            else:
                want = "labeled" if labels else kind
                got = inst.kind if not isinstance(inst, Labeled) \
                    else "labeled"
                if got != want or (isinstance(inst, Labeled)
                                   and inst.child_kind != kind):
                    raise ValueError(
                        f"{name}: already registered as a different "
                        f"instrument kind")
            return inst

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = (), overflow: str = "raise"):
        return self._get(name, "counter", help, labels, overflow)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = (), overflow: str = "raise"):
        return self._get(name, "gauge", help, labels, overflow)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None,
                  overflow: str = "raise", window: int = 0):
        return self._get(name, "histogram", help, labels, overflow,
                         buckets=buckets, window=window)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def get(self, name: str):
        return self._instruments.get(name)

    def snapshot(self) -> dict:
        """One-shot plain-dict snapshot of every instrument (the export
        sinks and ``Server.stats()`` both derive from this)."""
        return {name: inst.snapshot()
                for name, inst in sorted(self._instruments.items())}

    def reset(self) -> None:
        self._instruments.clear()


# ---------------------------------------------------------------------------
# process-wide default registry
# ---------------------------------------------------------------------------

_DEFAULT = Registry(enabled=False)      # ``enable()`` turns it on


def default_registry() -> Registry:
    return _DEFAULT


def enable() -> None:
    _DEFAULT.enable()


def disable() -> None:
    _DEFAULT.disable()


def enabled() -> bool:
    return _DEFAULT.enabled


def counter(name: str, help: str = "", labels: Sequence[str] = ()):
    return _DEFAULT.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()):
    return _DEFAULT.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None,
              window: int = 0):
    return _DEFAULT.histogram(name, help, labels, buckets=buckets,
                              window=window)


def snapshot() -> dict:
    return _DEFAULT.snapshot()
