"""Scoped ``torch.profiler`` capture + device memory snapshots: the port's
counterpart of the JAX package's ``repro.obs.jaxprof``.

The profiler is process-global and heavyweight, so this wrapper keeps it
strictly opt-in (``--prof``; ``out_dir=None`` is a no-op) and
failure-tolerant: a build without profiler support degrades to a no-op
instead of killing the serve loop. Each capture is written as a Chrome
trace under ``out_dir`` and keyed to obs spans by an instant event of the
same name on the tracer, so the Perfetto view of the obs trace and the
profiler's trace line up.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import torch

from repro_torch.obs.trace import Tracer


def device_memory_snapshot() -> dict:
    """``torch.cuda.memory_stats`` of every visible card (numeric entries
    only); an empty dict without CUDA."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[f"cuda:{i}"] = {k: int(v) for k, v in stats.items()
                                if isinstance(v, (int, float))}
    return out


class TorchProfiler:
    """Start/stop wrapper around ``torch.profiler.profile`` (CPU activity,
    and CUDA where a card is present).

    ``scope(name)`` is the span-keyed form: it emits ``prof:<name>``
    instants on the tracer with a device memory snapshot on entry and exit
    (in the event args), and writes the capture to
    ``<out_dir>/<name>.<n>.trace.json``; ``paths`` lists the files written.
    """

    def __init__(self, out_dir: Optional[str],
                 tracer: Optional[Tracer] = None):
        self.out_dir = out_dir
        self.tracer = tracer
        self.active = False
        self.available = out_dir is not None
        self.paths: List[str] = []
        self._prof = None
        self._name = "capture"

    def start(self, name: str = "capture") -> bool:
        if not self.available or self.active:
            return False
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._name, self.active = name, True
        except (RuntimeError, OSError):
            self._prof, self.available = None, False
        return self.active

    def stop(self) -> None:
        if not self.active:
            return
        try:
            self._prof.stop()
            path = os.path.join(
                self.out_dir, f"{self._name}.{len(self.paths)}.trace.json")
            self._prof.export_chrome_trace(path)
            self.paths.append(path)
        finally:
            self._prof, self.active = None, False

    @contextlib.contextmanager
    def scope(self, name: str):
        """Profile one region, keyed to the obs trace by name."""
        started = self.start(name)
        if self.tracer is not None:
            self.tracer.event(f"prof:{name}", phase="start",
                              mem=device_memory_snapshot())
        try:
            yield self
        finally:
            if self.tracer is not None:
                self.tracer.event(f"prof:{name}", phase="stop",
                                  mem=device_memory_snapshot())
            if started:
                self.stop()
