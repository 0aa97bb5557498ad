"""repro_torch.plan — sensitivity-profiled, budget-driven compression
planning.

Profile error-vs-rank curves in one pass (``sensitivity``), solve a
global parameter / byte / latency budget into per-weight ranks
(``allocate`` -> ``CompressionPlan``, the JAX package's JSON layout), and
optionally execute the plan as staged compress→heal rounds with
eval-in-the-loop early stopping (``progressive``). ``launch/plan.py`` is
the CLI; ``launch/cure.py`` consumes saved plans via ``--plan`` /
``--budget-*``.
"""
from repro_torch.plan.allocate import (
    BUDGET_KINDS,
    CompressionPlan,
    allocate,
    dense_cost,
    dtype_bytes_for,
    plan_for_model,
    resolve_budget,
    weight_cost,
)
from repro_torch.plan.progressive import (
    ProgressiveResult,
    RoundResult,
    progressive_cure,
)
from repro_torch.plan.sensitivity import (
    SensitivityProfile,
    WeightCurve,
    calib_hash,
    config_hash,
    default_grid,
    feasible_grid,
    profile_sensitivity,
)
