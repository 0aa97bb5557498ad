"""A capture reduced by stage of the program's compression: the program's
``cur.*`` ranges (its spans open a ``torch.profiler.record_function``
range while a capture records) against the device's kernel, copy and set
intervals, taken from the profiler's raw events as ``Trace.summary()``
takes them.

For each ``cur.*`` name: ``n`` ranges; ``wall_s``, their host self time
(their length less that of the ``cur.*`` ranges directly inside them);
``busy_s``, the device time (intervals merged) of the operations whose
launch call, matched by correlation id, lies in a range of that name as
the innermost ``cur.*`` range; ``idle_s``, the time within its ranges in
which the device ran nothing. ``cover`` is the share of the device's
busy time so attributed to some range. A capture of a program without
the ranges gives no names and a cover of 0.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Tuple

import torch

PREFIX = "cur."
# the host's launch calls, ``cuda*`` and low-level ``cu*`` API calls
# (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``); the
# profiler's operators number their correlation ids apart
LAUNCH = re.compile(r"^cu(da)?[A-Z]")


def _merge(intervals) -> List[List[int]]:
    merged: List[List[int]] = []
    for s0, s1 in sorted(intervals):
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s1)
        else:
            merged.append([s0, s1])
    return merged


def _length(merged) -> int:
    return sum(s1 - s0 for s0, s1 in merged)


def _overlap(merged, starts, t0: int, t1: int) -> int:
    """Length of ``merged`` (disjoint, sorted; ``starts`` its starts)
    inside [t0, t1]."""
    out = 0
    for k in range(max(bisect.bisect_right(starts, t0) - 1, 0), len(merged)):
        s0, s1 = merged[k]
        if s0 >= t1:
            break
        out += max(0, min(s1, t1) - max(s0, t0))
    return out


def _innermost(ranges, t: int) -> int:
    """Index of the innermost range (sorted by start, nested) holding t,
    or -1."""
    best = -1
    for i, (r0, r1, _) in enumerate(ranges):
        if r0 > t:
            break
        if t <= r1:
            best = i
    return best


def reduce(events) -> dict:
    """``events``: the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges: List[Tuple[int, int, str]] = []
    launch: Dict[int, int] = {}
    dev: List[Tuple[int, int, int]] = []
    for e in events:
        s0 = e.start_ns()
        s1 = s0 + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((s0, s1, e.correlation_id()))
        elif e.name().startswith(PREFIX):
            ranges.append((s0, s1, e.name()))
        elif LAUNCH.match(e.name()):
            launch[e.correlation_id()] = s0
    # by start, and an enclosing range before the ranges it holds
    ranges.sort(key=lambda r: (r[0], -r[1]))
    busy = _merge((s0, s1) for s0, s1, _ in dev)
    starts = [s0 for s0, _ in busy]
    owned: Dict[str, list] = {}
    for s0, s1, corr in dev:
        i = _innermost(ranges, launch[corr]) if corr in launch else -1
        if i >= 0:
            owned.setdefault(ranges[i][2], []).append((s0, s1))
    inner = [0] * len(ranges)
    for i, (r0, r1, _) in enumerate(ranges):
        for j in range(i - 1, -1, -1):
            if ranges[j][0] <= r0 and r1 <= ranges[j][1]:
                inner[j] += r1 - r0
                break
    out: Dict[str, dict] = {}
    for i, (r0, r1, name) in enumerate(ranges):
        st = out.setdefault(name, {"n": 0, "wall_s": 0.0, "busy_s": 0.0,
                                   "idle_s": 0.0})
        st["n"] += 1
        st["wall_s"] += (r1 - r0 - inner[i]) / 1e9
        st["idle_s"] += (r1 - r0 - _overlap(busy, starts, r0, r1)) / 1e9
    for name, iv in owned.items():
        out[name]["busy_s"] = _length(_merge(iv)) / 1e9
    total = _length(busy)
    cover = _length(_merge(iv for ivs in owned.values() for iv in ivs))
    return {"spans": out, "cover": cover / total if total else 0.0}
