"""Export sinks for the obs registry and tracer.

Three shapes, one source of truth (``Registry.snapshot()``):

  - :func:`snapshot` — one-shot plain dict (benchmarks embed it in
    their ``BENCH_*.json`` envelopes, ``Server.stats()`` derives from
    it);
  - :func:`to_prometheus` — Prometheus text exposition format
    (``# TYPE``/``# HELP`` + samples, ``_bucket``/``_sum``/``_count``
    for histograms) for scrape endpoints;
  - :class:`JsonlLog` — append-only JSONL event log (one dict per
    line, ``kind`` + wall-clock ``ts``), the CI artifact format.

:func:`write_all` drops the standard artifact set into a directory:
``metrics.json``, ``metrics.prom``, ``events.jsonl`` (if a log was
kept), ``trace.json`` (if a tracer was active).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import Tracer


def snapshot(registry: Registry) -> dict:
    return registry.snapshot()


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_").replace("/", "_")


def _escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, and
    newline must be escaped inside the quoted value."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """``# HELP`` escaping: backslash and newline (quotes are legal)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_type(t: str) -> str:
    """Snapshot type -> exposition type. Windowed histograms expose the
    same cumulative bucket/sum/count series as plain histograms (only
    their percentile basis differs), so both are ``histogram``."""
    if t.startswith("labeled_"):
        t = t[len("labeled_"):]
    return "histogram" if t == "windowed_histogram" else t


def _labels_suffix(key: str) -> str:
    """``stage=prefill,arch=olmo`` -> ``{stage="prefill",arch="olmo"}``"""
    if not key:
        return ""
    parts = [p.split("=", 1) for p in key.split(",")]
    return "{" + ",".join(f'{n}="{_escape_label_value(v)}"'
                          for n, v in parts) + "}"


def _prom_emit(lines, name, snap, label_key=""):
    suffix = _labels_suffix(label_key)
    t = _prom_type(snap["type"])
    if t in ("counter", "gauge"):
        lines.append(f"{name}{suffix} {snap['value']}")
    elif t == "histogram":
        cum = 0
        for ub, c in zip(snap["buckets"], snap["bucket_counts"]):
            cum += c
            le = f'le="{ub:g}"'
            lab = suffix[:-1] + "," + le + "}" if suffix \
                else "{" + le + "}"
            lines.append(f"{name}_bucket{lab} {cum}")
        lab = suffix[:-1] + ',le="+Inf"}' if suffix else '{le="+Inf"}'
        lines.append(f"{name}_bucket{lab} {snap['count']}")
        lines.append(f"{name}_sum{suffix} {snap['sum']}")
        lines.append(f"{name}_count{suffix} {snap['count']}")


def to_prometheus(registry: Registry) -> str:
    """Prometheus text exposition of every instrument (``# HELP`` +
    ``# TYPE`` + samples; label values and help text escaped per the
    text-format spec)."""
    lines = []
    for name, snap in sorted(registry.snapshot().items()):
        inst = registry.get(name)
        pname = _prom_name(name)
        help_text = getattr(inst, "help", "") if inst is not None else ""
        if help_text:
            lines.append(f"# HELP {pname} {_escape_help(help_text)}")
        lines.append(f"# TYPE {pname} {_prom_type(snap['type'])}")
        if snap["type"].startswith("labeled_"):
            for key, child in snap["children"].items():
                _prom_emit(lines, pname, child, key)
        else:
            _prom_emit(lines, pname, snap)
    return "\n".join(lines) + "\n"


class JsonlLog:
    """Append-only JSONL event log. ``log(kind, **fields)`` writes one
    line; pass ``path=None`` to buffer in memory (tests)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.buffered = []
        self._f = open(path, "a") if path else None

    def log(self, kind: str, **fields) -> dict:
        ev = {"ts": time.time(), "kind": kind, **fields}
        if self._f is not None:
            self._f.write(json.dumps(ev) + "\n")
            self._f.flush()
        else:
            self.buffered.append(ev)
        return ev

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def write_all(out_dir: str, *, registry: Optional[Registry] = None,
              tracer: Optional[Tracer] = None,
              extra: Optional[dict] = None) -> dict:
    """Write the standard artifact set; returns {name: path} written."""
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    if registry is not None:
        snap = registry.snapshot()
        if extra:
            snap = {**snap, **extra}
        p = os.path.join(out_dir, "metrics.json")
        with open(p, "w") as f:
            json.dump(snap, f, indent=1)
        written["metrics"] = p
        p = os.path.join(out_dir, "metrics.prom")
        with open(p, "w") as f:
            f.write(to_prometheus(registry))
        written["prometheus"] = p
    if tracer is not None and tracer.enabled:
        p = os.path.join(out_dir, "trace.json")
        tracer.save(p)
        written["trace"] = p
    return written
