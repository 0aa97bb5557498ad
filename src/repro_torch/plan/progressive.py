"""Progressive compress→heal execution of a budget plan.

Instead of compressing every planned layer at once and healing at the
end, the executor stages the layer set across rounds. Each round:

  1. re-CALIBRATES the current (partially compressed, healed) model —
     angular distances and WANDA stats reflect what healing changed;
  2. picks the next chunk of still-dense layers by angular redundancy;
  3. PROFILES them and ALLOCATES ranks at the global budget fraction
     (``repro_torch.plan.allocate``) — already-compressed weights are
     skipped by the work-list enumeration;
  4. COMPRESSES (``core/compress`` with the per-weight ranks, unfolded
     {C, U0, dU, R} form so dU stays trainable);
  5. HEALS with dU-only layer-wise KD against the round's pre-compression
     model (``core/heal``): in round 2 the teacher is round 1's model,
     whose CURed layers are unfolded leaves;
  6. EVALUATES ``train/evaluate.perplexity`` — a round whose healed
     perplexity degrades past ``max_ppl_increase`` over the previous
     accepted state is a no-gain round: it is reverted and the run stops
     early, keeping the best model so far.

Everything runs on the device of the calibration batches and params.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.configs.base import CURConfig, ModelConfig, OptimizerConfig
from repro_torch.core import angular, calibrate, compress_model
from repro_torch.core.heal import (
    combine_params, make_heal_step, partition_params, trainable_mask)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim.adamw import AdamW
from repro_torch.plan.allocate import CompressionPlan, allocate
from repro_torch.plan.sensitivity import profile_sensitivity
from repro_torch.train.evaluate import perplexity


@dataclasses.dataclass
class RoundResult:
    round: int
    layers: List[int]
    ranks: Dict[str, int]
    ppl_compressed: float        # after compression, before healing
    ppl: float                   # after healing (the round's verdict)
    accepted: bool
    heal_steps: int
    seconds: float
    plan: CompressionPlan


@dataclasses.dataclass
class ProgressiveResult:
    params: object               # best accepted params (unfolded CUR form)
    cfg: ModelConfig
    rounds: List[RoundResult]
    ppl_initial: float
    early_stopped: bool

    @property
    def ppl_final(self) -> float:
        accepted = [r.ppl for r in self.rounds if r.accepted]
        return accepted[-1] if accepted else self.ppl_initial

    @property
    def merged_ranks(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.rounds:
            if r.accepted:
                out.update(r.ranks)
        return out


def _split_layers(n_layers: int, rounds: int) -> List[int]:
    """How many NEW layers each round compresses (sums to n_layers)."""
    return [n_layers * (i + 1) // rounds - n_layers * i // rounds
            for i in range(rounds)]


def _heal(params, cfg, teacher_params, teacher_cfg, *, steps: int,
          batch_at: Callable[[int], dict], opt_cfg: OptimizerConfig,
          step_offset: int):
    tr, fr = partition_params(params, trainable_mask(params, "dU"))
    opt = AdamW(opt_cfg)
    opt_state = opt.init(tr)
    step = make_heal_step(cfg, teacher_cfg, teacher_params, opt)
    loss = None
    for s in range(steps):
        tr, opt_state, loss = step(tr, fr, opt_state,
                                   batch_at(step_offset + s))
    return combine_params(tr, fr), loss


def progressive_cure(params, cfg: ModelConfig, *,
                     budget_kind: str = "params", budget_value: float,
                     n_layers: int, rounds: int = 2,
                     calib_batches: Sequence[dict],
                     eval_batches: Sequence[dict],
                     heal_batch_at: Optional[Callable[[int], dict]] = None,
                     heal_steps: int = 0,
                     cur_cfg: Optional[CURConfig] = None,
                     grid: Optional[Sequence[int]] = None,
                     solver: str = "greedy", dtype_bytes: int = 4,
                     opt_cfg: Optional[OptimizerConfig] = None,
                     max_ppl_increase: float = 0.10,
                     arch: str = "", verbose: bool = False,
                     tracer=None,
                     ) -> ProgressiveResult:
    """Stage ``n_layers`` of compression across ``rounds`` rounds at the
    global ``budget_value`` (per-weight budget fraction identical to the
    one-shot plan, so the FINAL budget matches one-shot exactly).

    The budget fraction must be relative (``<= 1``) for params/bytes
    budgets — each round applies it to its own layer chunk, which keeps
    the cumulative allocation at the global fraction. ``heal_steps`` is
    the per-round heal length; ``heal_batch_at(i)`` supplies batch i of a
    shared stream so rounds never reuse data.
    """
    if budget_kind in ("params", "bytes") and budget_value > 1.0:
        raise ValueError(
            "progressive rounds need a fractional params/bytes budget "
            f"(got absolute {budget_value}); the fraction is applied "
            "per round-chunk so the total matches one-shot")
    if heal_steps and heal_batch_at is None:
        raise ValueError("heal_steps > 0 needs heal_batch_at")
    base = cur_cfg or CURConfig()
    if base.fold_u:
        raise ValueError("progressive healing needs the unfolded "
                         "{C, U0, dU, R} form (CURConfig.fold_u=False); "
                         "fold with fold_cur() after the final round")
    opt_cfg = opt_cfg or OptimizerConfig(
        lr=3e-4, warmup_steps=max(1, heal_steps // 10),
        total_steps=max(1, heal_steps * rounds))

    tracer = tracer or NULL_TRACER
    # per-round gauges on the default registry (NULL unless obs is on):
    # the round label is bounded by the rounds argument, so "raise" holds
    g_ppl_c = obs_metrics.default_registry().gauge(
        "repro_plan_round_ppl_compressed",
        "eval perplexity after compression, before healing",
        labels=("round",))
    g_ppl_h = obs_metrics.default_registry().gauge(
        "repro_plan_round_ppl_healed",
        "eval perplexity after the round's healing",
        labels=("round",))
    c_rounds = obs_metrics.counter(
        "repro_plan_rounds_total", "progressive rounds executed")

    cur_params, cur_cfg_m = params, cfg
    ppl_initial = perplexity(params, cfg, eval_batches)
    prev_ppl = ppl_initial
    compressed: set = set()
    results: List[RoundResult] = []
    early = False
    chunks = _split_layers(n_layers, rounds)

    for i in range(rounds):
        if chunks[i] == 0:       # rounds > n_layers front-loads empty chunks
            continue
        candidates = [li for li in range(1, cur_cfg_m.n_layers - 1)
                      if li not in compressed]
        if not candidates:
            break
        t0 = time.perf_counter()
        with tracer.span("round", round=i):
            with tracer.span("calibrate", round=i):
                calib = calibrate(cur_params, cur_cfg_m,
                                  list(calib_batches))
            distances = angular.layer_distances(calib.hidden)
            order = sorted(candidates, key=lambda li: distances[li])
            layers_i = sorted(order[:chunks[i]])

            with tracer.span("profile_allocate", round=i):
                profile = profile_sensitivity(cur_params, cur_cfg_m, base,
                                              calib, grid=grid,
                                              layers=layers_i)
                plan = allocate(profile, budget_kind, budget_value,
                                arch=arch, solver=solver, fold_u=False,
                                dtype_bytes=dtype_bytes, seed=base.seed)
            ccfg = plan.to_cur_config(base)
            with tracer.span("compress", round=i):
                new_params, new_cfg, _ = compress_model(
                    cur_params, cur_cfg_m, ccfg, calib, layers=layers_i)
            ppl_c = perplexity(new_params, new_cfg, eval_batches)

            if heal_steps:
                with tracer.span("heal", round=i):
                    new_params, _ = _heal(
                        new_params, new_cfg, cur_params, cur_cfg_m,
                        steps=heal_steps, batch_at=heal_batch_at,
                        opt_cfg=opt_cfg, step_offset=i * heal_steps)
            ppl_h = perplexity(new_params, new_cfg, eval_batches)

        g_ppl_c.labels(round=i).set(ppl_c)
        g_ppl_h.labels(round=i).set(ppl_h)
        c_rounds.inc()
        ok = ppl_h <= prev_ppl * (1.0 + max_ppl_increase)
        results.append(RoundResult(
            round=i, layers=layers_i, ranks=dict(plan.ranks),
            ppl_compressed=ppl_c, ppl=ppl_h, accepted=ok,
            heal_steps=heal_steps, seconds=time.perf_counter() - t0,
            plan=plan))
        if verbose:
            print(f"[plan] round {i}: layers {layers_i} "
                  f"ppl {ppl_c:.2f} -> healed {ppl_h:.2f} "
                  f"({'accepted' if ok else 'NO GAIN - reverting'})")
        if not ok:
            early = True                 # no-gain round: keep previous model
            break
        cur_params, cur_cfg_m = new_params, new_cfg
        prev_ppl = ppl_h
        compressed.update(layers_i)

    return ProgressiveResult(params=cur_params, cfg=cur_cfg_m,
                             rounds=results, ppl_initial=ppl_initial,
                             early_stopped=early)
