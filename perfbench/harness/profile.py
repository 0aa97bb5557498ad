"""The traced sub-window: ``torch.profiler`` over a short steady stretch of
the measured window, and the program's kernel launch counters.

``Trace.summary()`` reduces the capture to what the per-layer readers
take: device busy seconds (the union of the device's kernel, copy and set
intervals), the traced window's wall seconds, device time by operation
name, and the longest idle gaps labelled by what the host was doing.
"""
from __future__ import annotations

import importlib
import time
from typing import Dict

import torch

# the modules of the program's three kernel launchers
KERNELS = {
    "cur_matmul": "repro_torch.kernels.cur_matmul.cur_matmul",
    "flash_attention": "repro_torch.kernels.flash_attention.flash_attention",
    "paged_attention": "repro_torch.kernels.paged_attention.paged_attention",
}


def launches() -> Dict[str, int]:
    """The program's launch counter of each kernel."""
    return {k: int(importlib.import_module(mod).launches)
            for k, mod in KERNELS.items()}


class Trace:
    """Context manager: run the profiler; after it ends, ``summary()``."""

    def __init__(self):
        self.prof = None
        self.wall_s = 0.0

    def __enter__(self):
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=act)
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        """Reduce the capture, from the profiler's raw events (building
        its event tree costs minutes on long captures)."""
        cuda = torch.autograd.DeviceType.CUDA
        dev, cpu = [], []
        for e in self.prof.profiler.kineto_results.events():
            s0 = e.start_ns()
            s1 = s0 + e.duration_ns()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    dev.append((s0, s1, e.name()))
            else:
                cpu.append((s0, s1, e.name()))
        dev.sort()
        merged = []
        for s0, s1, _ in dev:
            if merged and s0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s1)
            else:
                merged.append([s0, s1])
        busy_ns = sum(t - s for s, t in merged)
        by_op: Dict[str, float] = {}
        for s0, s1, n in dev:
            by_op[n] = by_op.get(n, 0.0) + (s1 - s0) / 1e9
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(merged, merged[1:])), reverse=True)
        labelled = []
        for dur, g0, g1 in gaps[:10]:
            mid = (g0 + g1) // 2
            inner = [c for c in cpu if c[0] <= mid <= c[1]]
            label = "host"
            if inner:
                inner.sort(key=lambda c: c[1] - c[0])
                label += ": " + inner[0][2][:60]
            labelled.append([label, dur / 1e9])
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_ns / 1e9, "window_s": self.wall_s,
                "device_ops": [[n[:80], s] for n, s in top],
                "idle_gaps": labelled}
