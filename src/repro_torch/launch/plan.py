"""Budget-driven compression planning CLI (repro_torch.plan).

    # profile + allocate a parameter budget, save the plan
    PYTHONPATH=src python -m repro_torch.launch.plan --arch olmo-1b \
        --smoke --budget-params 0.6 --layers 2 --out results/plan/olmo.json

    # staged compress->heal on the trained zoo model with early stopping
    PYTHONPATH=src python -m repro_torch.launch.plan --zoo \
        --budget-params 0.5 --layers 3 --progressive --rounds 2 \
        --heal-steps 20

The emitted ``CompressionPlan`` JSON (the JAX package's layout) feeds
``launch/cure.py --plan`` (of either package) and reproduces the same
selections on the seed it records. Exactly one of ``--budget-params``
(fraction of targeted params, or absolute count), ``--budget-bytes``
(fraction or absolute bytes), or ``--budget-latency-ms`` (absolute H100
roofline milliseconds) must be given. Runs on ``--device`` (default the
card).
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch import obs, resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import CURConfig
from repro_torch.core import calibrate
from repro_torch.data.tokens import DataConfig, SyntheticLM
from repro_torch.models import init_params
from repro_torch.plan import plan_for_model, progressive_cure
from repro_torch.plan.allocate import budget_from_args, parse_grid


def _init_model(args, device):
    if args.zoo:
        from repro_torch.zoo import get_trained_repro
        params, cfg = get_trained_repro(quick=True, device=device)
        return params, cfg, cfg.name
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} uses the embeddings stub")
    return init_params(args.seed, cfg, device), cfg, cfg.name


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--zoo", action="store_true",
                    help="plan on the trained small-scale zoo model "
                         "instead of a freshly initialized arch")
    ap.add_argument("--budget-params", type=float, default=None,
                    help="<=1: fraction of targeted dense params; "
                         ">1: absolute param count")
    ap.add_argument("--budget-bytes", type=float, default=None)
    ap.add_argument("--budget-latency-ms", type=float, default=None,
                    help="absolute H100 roofline milliseconds")
    ap.add_argument("--layers", type=int, default=2,
                    help="how many layers to plan over (angular choice)")
    ap.add_argument("--solver", default="greedy", choices=("greedy", "dp"))
    ap.add_argument("--grid", default=None,
                    help="comma-separated rank grid (default: powers of "
                         "two up to --r-max)")
    ap.add_argument("--r-max", type=int, default=64)
    ap.add_argument("--selection", default="wanda_deim",
                    choices=("wanda_deim", "deim"))
    ap.add_argument("--svd", default="exact", choices=("exact", "randomized"))
    ap.add_argument("--no-fold", action="store_true")
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--calib-batch", type=int, default=2)
    ap.add_argument("--calib-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="plan JSON path (default results/plan/<arch>.json)")
    ap.add_argument("--device", default="cuda")
    # progressive execution
    ap.add_argument("--progressive", action="store_true",
                    help="execute staged compress->heal rounds with "
                         "eval-in-the-loop early stopping")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--heal-steps", type=int, default=20)
    ap.add_argument("--max-ppl-increase", type=float, default=0.10)
    ap.add_argument("--eval-batches", type=int, default=2)
    # observability (repro_torch.obs)
    ap.add_argument("--obs", action="store_true",
                    help="enable the process-wide metrics registry and "
                         "write metrics.json/.prom to --obs-out")
    ap.add_argument("--obs-out", default="results/obs/plan",
                    help="directory for obs artifacts")
    ap.add_argument("--trace", action="store_true",
                    help="record planning/round spans and write a "
                         "Chrome/Perfetto trace.json")
    ap.add_argument("--prof", action="store_true",
                    help="capture a torch.profiler trace under "
                         "--obs-out/torchprof")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    kind, value = budget_from_args(args)
    device = resolve_device(args.device)
    if args.obs:
        obs.enable()
    tracer = obs.Tracer(enabled=args.trace, process="repro_torch.plan")
    prof = obs.TorchProfiler(
        os.path.join(args.obs_out, "torchprof") if args.prof else None,
        tracer=tracer)

    def _export():
        if args.obs or args.trace:
            written = obs.write_all(
                args.obs_out,
                registry=obs.default_registry() if args.obs else None,
                tracer=tracer)
            for kind_, path in written.items():
                print(f"  obs {kind_} -> {path}")

    params, cfg, arch_name = _init_model(args, device)
    if args.out is None:
        args.out = os.path.join("results", "plan", f"{arch_name}.json")

    if args.zoo:
        from repro_torch.zoo import data_config, eval_batches
        ds = SyntheticLM(data_config(cfg, seed=1), device)
        evalb = eval_batches(cfg, n=args.eval_batches, device=device)
    else:
        ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.calib_len,
                                    global_batch=args.calib_batch,
                                    seed=args.seed), device)
        evalb = [ds.batch_at(10_000 + i) for i in range(args.eval_batches)]
    batches = [ds.batch_at(i) for i in range(args.calib_batches)]

    if args.progressive:
        if args.zoo:
            from repro_torch.zoo import data_config as zoo_data_config
            heal_ds = SyntheticLM(zoo_data_config(cfg, seed=2), device)
        else:
            heal_ds = SyntheticLM(DataConfig(
                vocab_size=cfg.vocab_size, seq_len=args.calib_len,
                global_batch=args.calib_batch, seed=args.seed + 2), device)
        with prof.scope("progressive"):
            res = progressive_cure(
                params, cfg, budget_kind=kind, budget_value=value,
                n_layers=args.layers, rounds=args.rounds,
                calib_batches=batches, eval_batches=evalb,
                heal_batch_at=heal_ds.batch_at,
                heal_steps=args.heal_steps,
                cur_cfg=CURConfig(r_max=args.r_max,
                                  selection=args.selection,
                                  svd=args.svd, fold_u=False,
                                  seed=args.seed),
                grid=parse_grid(args.grid), solver=args.solver,
                max_ppl_increase=args.max_ppl_increase, arch=arch_name,
                verbose=True, tracer=tracer)
        print(f"progressive: ppl {res.ppl_initial:.2f} -> "
              f"{res.ppl_final:.2f} over {len(res.rounds)} round(s)"
              f"{' (early stop)' if res.early_stopped else ''}")
        accepted = [r for r in res.rounds if r.accepted]
        if accepted:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            accepted[-1].plan.save(args.out)
            print(f"  last accepted round's plan -> {args.out}")
        _export()
        return res

    ccfg = CURConfig(r_max=args.r_max, n_compress_layers=args.layers,
                     selection=args.selection, svd=args.svd,
                     fold_u=not args.no_fold, seed=args.seed)
    t0 = time.perf_counter()
    with tracer.span("calibrate"), prof.scope("calibrate"):
        calib = calibrate(params, cfg, batches)
    with tracer.span("profile_allocate"), prof.scope("profile_allocate"):
        plan, profile = plan_for_model(
            params, cfg, ccfg, calib, budget_kind=kind,
            budget_value=value, n_layers=args.layers,
            grid=parse_grid(args.grid), solver=args.solver,
            arch=arch_name)
    dt = time.perf_counter() - t0

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    plan.save(args.out)

    r = plan.realized
    print(f"planned {arch_name} on {device}: {len(plan.ranks)} weights in "
          f"layers {plan.layers} ({args.solver}, {dt:.2f}s total, profile "
          f"{profile.seconds:.2f}s)")
    print(f"  budget[{kind}]: requested {plan.budget_requested:.4g} -> "
          f"realized {r[f'{kind}_after']:.4g} "
          f"(x{r['fraction']:.3f} of dense"
          f"{'' if plan.feasible else ', INFEASIBLE'})")
    for key in sorted(plan.ranks, key=lambda k: (int(k.split(':')[0]), k)):
        print(f"    {key:>16s}  r={plan.ranks[key]:<4d} "
              f"pred_rel_err={plan.predicted['rel_err'][key]:.4f}")
    print(f"  plan -> {args.out}")
    _export()
    return plan


if __name__ == "__main__":
    main()
