"""repro_torch.testing — deterministic fault injection for robustness tests.

  chaos    seeded FaultPlan (latency spikes, transient step exceptions,
           pool squeezes, queue storms, checkpoint corruption) injected
           through explicit hooks in the serving stack and replayable
           from a JSON spec
"""
from repro_torch.testing.chaos import (
    ChaosEngine, FaultEvent, FaultPlan, FaultSpec, InjectedFault,
    corrupt_checkpoint)

__all__ = [
    "ChaosEngine",
    "FaultEvent",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "corrupt_checkpoint",
]
