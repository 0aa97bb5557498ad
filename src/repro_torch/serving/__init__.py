"""repro_torch.serving — continuous-batching inference runtime.

Layered as:

  server.Server        synchronous submit/step/drain front-end + stats
      scheduler.Scheduler   admission queue, slots, preemption policy
          paged_cache       block-table paged KV pool (+ CUR-KV mode)
          runtime           paged prefill / decode model steps
          sampling          per-request token sampling
      resilience            bounded admission, deadlines, degradation
                            ladder, watchdog

Speculative decoding (``repro.serving.speculative``) is not ported yet.
"""
from repro_torch.serving.paged_cache import BlockAllocator, PagedConfig
from repro_torch.serving.resilience import (
    DegradationLadder, QueueFull, ResilienceConfig, ServerWedged)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.server import Server

__all__ = [
    "BlockAllocator",
    "DegradationLadder",
    "PagedConfig",
    "QueueFull",
    "Request",
    "ResilienceConfig",
    "SamplingParams",
    "Scheduler",
    "Server",
    "ServerWedged",
]
