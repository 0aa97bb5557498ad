"""repro_torch.obs — metrics, spans, load generation and SLO evaluation
for the serving runtime. Host-side and numpy-only: copies of the JAX
package's ``repro.obs`` modules of the same names (the port imports
nothing of ``repro``).

  metrics    process-wide registry: counters, gauges, labeled histograms
  trace      span tracker, per-request lanes, Chrome-trace JSON export;
             spans open torch.profiler ranges while a capture records
  export     snapshot dict, Prometheus text, JSONL event log, write_all
  loadgen    seeded synthetic workloads + the open-loop load runner
  slo        SLO spec + evaluation: attainment, goodput, decomposition
  torchprof  scoped torch.profiler capture + device memory snapshots
             (the counterpart of ``repro.obs.jaxprof``)
"""
from repro_torch.obs import loadgen, slo
from repro_torch.obs.export import (
    JsonlLog, snapshot, to_prometheus, write_all)
from repro_torch.obs.loadgen import LengthDist, WorkloadSpec
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS, NULL, Counter, Gauge, Histogram, Registry, counter,
    default_registry, disable, enable, enabled, gauge, histogram,
    log_buckets)
from repro_torch.obs.slo import SLOMonitor, SLOSpec
from repro_torch.obs.torchprof import TorchProfiler, device_memory_snapshot
from repro_torch.obs.trace import (
    ENGINE_TRACK, NULL_CTX, NULL_TRACER, Tracer, request_track)

__all__ = [
    "Counter", "Gauge", "Histogram", "LengthDist", "Registry",
    "SLOMonitor", "SLOSpec", "TorchProfiler", "Tracer", "JsonlLog",
    "WorkloadSpec", "DEFAULT_BUCKETS", "ENGINE_TRACK", "NULL", "NULL_CTX",
    "NULL_TRACER", "counter", "default_registry", "device_memory_snapshot",
    "disable", "enable", "enabled", "gauge", "histogram", "loadgen",
    "log_buckets", "request_track", "slo", "snapshot", "to_prometheus",
    "write_all",
]
