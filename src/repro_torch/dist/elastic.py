"""Elastic recovery planning after chip/pod failures (``repro.dist.elastic``
in the JAX package, pure Python).

Policy (DESIGN.md §4): tensor-parallel width is a hardware-topology
invariant (one TP group = one NVLink domain), so recovery never re-slices the
model — it shrinks the data-parallel degree to the largest power of two
that fits on the surviving chips and parks the remainder as hot spares
for the repair controller. Pow-2 data parallelism keeps every collective
on power-of-two replica groups (ring/bucket schedules stay optimal) and
keeps the global batch divisible after re-sharding; the deterministic
``batch_at(step)`` data pipeline (repro_torch.data.tokens) makes the resume
exact with no iterator state.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    healthy_chips: int
    tp_width: int
    new_data_parallel: int
    spare_chips: int
    resume_step: int
    note: str

    @property
    def active_chips(self) -> int:
        return self.new_data_parallel * self.tp_width


def plan_recovery(*, total_chips: int, failed_chips: int, tp_width: int,
                  resume_step: int) -> RecoveryPlan:
    """Re-plan the mesh after ``failed_chips`` of ``total_chips`` died.

    Returns the pow-2 data-parallel re-plan; raises if fewer than one TP
    group survives (nothing to elastically resume onto)."""
    if failed_chips < 0 or failed_chips > total_chips:
        raise ValueError(f"failed_chips={failed_chips} out of range")
    healthy = total_chips - failed_chips
    replicas = healthy // tp_width
    if replicas < 1:
        raise RuntimeError(
            f"{healthy} healthy chips cannot host one tp={tp_width} group")
    new_dp = 1 << (replicas.bit_length() - 1)     # largest pow2 <= replicas
    spares = healthy - new_dp * tp_width
    note = (f"resume at step {resume_step}: dp {replicas} -> pow2 {new_dp} "
            f"x tp {tp_width} = {new_dp * tp_width} active chips, "
            f"{spares} spare chips held for repair")
    return RecoveryPlan(healthy_chips=healthy, tp_width=tp_width,
                        new_data_parallel=new_dp, spare_chips=spares,
                        resume_step=resume_step, note=note)
