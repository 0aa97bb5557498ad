"""Span tracker with Chrome-trace / Perfetto JSON export.

A :class:`Tracer` records complete spans — ``(name, start, duration,
track, attrs)`` — via a context manager or decorator, plus instant
events. The export is the Chrome ``traceEvents`` array format (``ph:
"X"`` complete events, ``ph: "i"`` instants), which both
``chrome://tracing`` and https://ui.perfetto.dev open directly.

Tracks map to Chrome-trace ``tid`` lanes: engine-level spans live on
track 0, per-request lifecycle spans (queued -> prefill -> decode-window
-> spec-draft/verify -> done) on ``track = rid + 1`` so every request
renders as its own swimlane.

While a ``torch.profiler`` capture is recording, every span, of an
enabled tracer or not (``NULL_TRACER`` too), also opens a
``torch.profiler.record_function`` range under its name, so the spans
appear in the capture beside the kernels they launch. That is checked
at each span; a span never synchronises the device.

A disabled tracer with no capture recording is free: ``span()`` returns
one shared null context manager and ``event()`` returns immediately —
no object is allocated per call.

The export's ``ts`` are microseconds from the tracer's epoch, whose
``perf_counter`` and Unix time (``time.time_ns()``, the profiler's
clock) are ``otherData.clock_anchor``: a span's Unix nanoseconds are
``unix_ns + 1000 ts``, as an event's are ``baseTimeNanoseconds + 1000
ts`` in the profiler's own Chrome export, so ``trace.json`` and a
``torchprof/*.trace.json`` of one run lie on one timeline.
"""
from __future__ import annotations

import functools
import json
import time
from typing import Dict, List, Optional

import torch

ENGINE_TRACK = 0


def request_track(rid: int) -> int:
    """Chrome-trace lane for request ``rid`` (engine lane is 0)."""
    return rid + 1


class _NullCtx:
    """Shared no-op context manager for disabled tracers."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_CTX = _NullCtx()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` capture is recording."""
    return torch.autograd._profiler_enabled()


class _RangeCtx(_NullCtx):
    """A disabled tracer's span while a capture records: the profiler
    range alone."""
    __slots__ = ("rf",)

    def __init__(self, name: str):
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        return False


class _SpanCtx:
    __slots__ = ("tracer", "name", "track", "attrs", "t0", "rf")

    def __init__(self, tracer: "Tracer", name: str, track: int,
                 attrs: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs
        self.t0 = 0.0
        self.rf = None

    def set(self, **attrs):
        """Attach attributes from inside the span body."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tracer.add_span(self.name, self.t0,
                             time.perf_counter() - self.t0,
                             track=self.track, attrs=self.attrs)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Tracer:
    """Append-only span/event recorder. Timestamps are
    ``time.perf_counter()`` seconds relative to the tracer's epoch, whose
    Unix time (``time.time_ns()``, the profiler's clock) is
    ``epoch_ns``."""

    def __init__(self, enabled: bool = True, process: str = "repro"):
        self.enabled = enabled
        self.process = process
        self.epoch = time.perf_counter()
        self.epoch_ns = time.time_ns()
        self.spans: List[dict] = []
        self.events: List[dict] = []
        self._track_names: Dict[int, str] = {ENGINE_TRACK: "engine"}

    def name_track(self, track: int, name: str) -> None:
        self._track_names[track] = name

    def span(self, name: str, track: int = ENGINE_TRACK,
             **attrs):
        """``with tracer.span("prefill", batch=4): ...``"""
        if not self.enabled:
            return _RangeCtx(name) if _profiling() else NULL_CTX
        return _SpanCtx(self, name, track, attrs or None)

    def wrap(self, name: Optional[str] = None, track: int = ENGINE_TRACK):
        """Decorator form: times every call of the wrapped function."""
        def deco(fn):
            label = name or fn.__name__

            @functools.wraps(fn)
            def inner(*a, **kw):
                with self.span(label, track=track):
                    return fn(*a, **kw)
            return inner
        return deco

    def add_span(self, name: str, t0: float, dur: float,
                 track: int = ENGINE_TRACK,
                 attrs: Optional[dict] = None) -> None:
        """Record an already-timed span (t0 in perf_counter seconds)."""
        if not self.enabled:
            return
        self.spans.append({"name": name, "t0": t0 - self.epoch,
                           "dur": dur, "track": track,
                           "attrs": attrs or {}})

    def event(self, name: str, track: int = ENGINE_TRACK,
              **attrs) -> None:
        """Instant event (renders as a tick mark)."""
        if not self.enabled:
            return
        self.events.append({"name": name,
                            "t0": time.perf_counter() - self.epoch,
                            "track": track, "attrs": attrs or {}})

    # -- export ---------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome/Perfetto ``traceEvents`` JSON (timestamps in us)."""
        ev: List[dict] = []
        ev.append({"ph": "M", "pid": 0, "tid": 0,
                   "name": "process_name",
                   "args": {"name": self.process}})
        for track, tname in sorted(self._track_names.items()):
            ev.append({"ph": "M", "pid": 0, "tid": track,
                       "name": "thread_name", "args": {"name": tname}})
        for s in self.spans:
            ev.append({"ph": "X", "pid": 0, "tid": s["track"],
                       "name": s["name"], "ts": s["t0"] * 1e6,
                       "dur": s["dur"] * 1e6, "args": s["attrs"]})
        for e in self.events:
            ev.append({"ph": "i", "pid": 0, "tid": e["track"], "s": "t",
                       "name": e["name"], "ts": e["t0"] * 1e6,
                       "args": e["attrs"]})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"clock_anchor": {
                    "perf_counter_s": self.epoch,
                    "unix_ns": self.epoch_ns}}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def durations(self, track: Optional[int] = None) -> Dict[str, float]:
        """Total seconds per span name (the ``stages_s`` derivation), of
        one track's spans when ``track`` is given."""
        out: Dict[str, float] = {}
        for s in self.spans:
            if track is None or s["track"] == track:
                out[s["name"]] = out.get(s["name"], 0.0) + s["dur"]
        return out


class _NullTracer(Tracer):
    """Always-disabled tracer: safe default for un-instrumented callers."""

    def __init__(self):
        super().__init__(enabled=False)

    def event(self, name, track=ENGINE_TRACK, **attrs):
        return None

    def add_span(self, *a, **kw):
        return None


NULL_TRACER = _NullTracer()
