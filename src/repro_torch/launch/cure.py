"""One-shot CURing on the GPU: the end-to-end compression pipeline.

    PYTHONPATH=src python -m repro_torch.launch.cure --arch llama3.1-8b \
        --layers 10 --r-max 256 --report results/cure/llama.json

Stages, each a span of an ``obs.Tracer`` that ends in a device
synchronise: init (random params made on the device) -> calibrate -> plan
(uniform ranks, a saved ``--plan``, or a ``--budget-*`` allocated by
``repro_torch.plan``) -> compress (batched shape-class pipeline by
default) -> fold C@U -> save (``dist.CheckpointManager``, step 0 of
``--ckpt-dir``, with its ``template.json``) -> draft (``--emit-draft``: the
same checkpoint compressed to a plan-allocated budget, saved under
``<ckpt-dir>/draft`` with its ``plan.json``) -> smoke-generate through
``repro_torch.serving`` (the static-batch engine for archs the paged
runtime does not take). The report keeps the JAX launcher's schema
(``stages_s``, ``plan``, ``params.*``, ``weights[]``, ``layers_compressed``,
``generate``, ``draft``); ``stages_s.total`` covers every stage.

``--obs`` writes the ``repro_compress_*`` metrics, ``--trace`` the stage
spans (Chrome trace) to ``--obs-out``, with the compression's own cur.*
spans (``core.compress``) on a lane of their own; ``--prof`` captures
``torch.profiler`` traces of calibrate and compress under
``--obs-out/torchprof``, which hold the cur.* ranges.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs import (
    ARCHS, PORT_ARCHS, get_config, get_smoke)
from repro_torch.configs.base import CURConfig, ModelConfig
from repro_torch.core import CalibStats, calibrate, compress_model
from repro_torch.core.compress import CompressInfo, rank_key
from repro_torch.data.tokens import DataConfig, SyntheticLM
from repro_torch.dist.checkpoint import CheckpointManager, save_tree_template
from repro_torch.models import init_params
from repro_torch.plan import CompressionPlan, config_hash, plan_for_model
from repro_torch.plan.allocate import budget_from_args, parse_grid
from repro_torch.serve.engine import generate
from repro_torch.serving import PagedConfig, SamplingParams, Server
from repro_torch.serving.paged_cache import supports as paged_supports


@dataclasses.dataclass
class CureRun:
    """A finished run: its report, both models (original and CURed), the
    calibration statistics and the compression's per-weight record."""
    report: dict
    cfg: ModelConfig
    params: Any
    cured_cfg: ModelConfig
    cured_params: Any
    calib: CalibStats
    info: CompressInfo


def _smoke_generate(params, cfg, *, n_requests: int, prompt_len: int,
                    new_tokens: int, max_concurrency: int, seed: int,
                    device):
    """Drive the compressed model through the serving runtime on
    ``device`` (paged continuous batching when the arch supports it, else
    the static-batch engine). Returns (n_tokens, engine_name)."""
    rng = np.random.RandomState(seed)
    if paged_supports(cfg):
        max_len = prompt_len + new_tokens
        pc = PagedConfig.sized_for(max_len, max_concurrency)
        server = Server(params, cfg, pc, max_concurrency=max_concurrency,
                        device=device)
        for i in range(n_requests):
            prompt = rng.randint(0, cfg.vocab_size, size=prompt_len).tolist()
            server.submit(prompt, new_tokens,
                          sampling=SamplingParams(temperature=0.0, seed=i))
        finished = server.drain()
        return sum(len(r.out_tokens) for r in finished.values()), "serving"
    prompts = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(n_requests, prompt_len))).to(device)
    out = generate(params, cfg, prompts, new_tokens)
    return int(out.tokens.numel()), "legacy"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _stage(tracer, name, device):
    """A tracer span that ends in a device synchronise, so that it times
    the stage's device work and not only its enqueue."""
    with tracer.span(name):
        yield
        _sync(device)


def _base_cur_config(args, n_layers: int) -> CURConfig:
    return CURConfig(r_max=args.r_max, n_compress_layers=n_layers,
                     selection=args.selection, svd=args.svd,
                     fold_u=not args.no_fold, pipeline=args.pipeline,
                     seed=args.seed)


def build_draft(params, cfg, calib, args):
    """The ``--emit-draft`` companion, in memory: the same params
    compressed to ``--draft-budget-params`` over ``--draft-layers``
    layers, ranks allocated by ``plan_for_model``. Returns (params, cfg,
    plan, CompressInfo)."""
    n_layers = args.draft_layers if args.draft_layers is not None \
        else args.layers
    dccfg = _base_cur_config(args, n_layers)
    dplan, _ = plan_for_model(
        params, cfg, dccfg, calib, budget_kind="params",
        budget_value=args.draft_budget_params, n_layers=n_layers,
        grid=parse_grid(args.grid), solver=args.solver, arch=cfg.name)
    dparams, dcfg, dinfo = compress_model(
        params, cfg, dplan.to_cur_config(dccfg), calib, layers=dplan.layers)
    return dparams, dcfg, dplan, dinfo


def _save(directory, tree) -> None:
    CheckpointManager(directory, keep_n=1).save(0, tree)
    save_tree_template(os.path.join(directory, "template.json"), tree)


def cure_run(args, *, tracer=None) -> CureRun:
    """The pipeline's run; ``tracer`` (an enabled ``obs.Tracer``) takes its
    stage spans, a fresh one when None."""
    device = resolve_device(args.device)
    budget = budget_from_args(args, required=False)
    if budget and args.plan:
        raise SystemExit("--plan and --budget-* exclude each other")
    # per-stage timing lives on a span tracer (always on: it IS the
    # stages_s report); --trace additionally writes its Chrome trace
    tracer = tracer or obs.Tracer(enabled=True, process="repro_torch.cure")
    if args.obs:
        obs.enable()
    prof = obs.TorchProfiler(
        os.path.join(args.obs_out, "torchprof") if args.prof else None,
        tracer=tracer)
    ckpt_dir = args.ckpt_dir or os.path.join("results", "cure", args.arch)
    t_total = time.perf_counter()

    # ---- init ---------------------------------------------------------
    with _stage(tracer, "init", device):
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        if cfg.input_mode != "tokens":
            raise SystemExit(f"{args.arch} uses the embeddings stub")
        params = init_params(args.seed, cfg, device)

    # ---- calibrate ----------------------------------------------------
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=args.calib_len,
                                global_batch=args.calib_batch,
                                seed=args.seed), device)
    batches = [ds.batch_at(i) for i in range(args.calib_batches)]
    with _stage(tracer, "calibrate", device), prof.scope("calibrate"):
        calib = calibrate(params, cfg, batches)

    # ---- plan (repro_torch.plan: budget -> per-weight ranks) -----------
    ccfg = _base_cur_config(args, args.layers)
    plan, plan_source, layers = None, "uniform", None
    with _stage(tracer, "plan", device):
        if args.plan:
            plan = CompressionPlan.load(args.plan)
            plan_source = "file"
            if plan.provenance.get("cfg_hash") != config_hash(cfg):
                print(f"  WARNING: plan {args.plan} was computed for a "
                      f"different model config (cfg_hash mismatch) — "
                      f"selections may not reproduce")
        elif budget is not None:
            plan, _ = plan_for_model(
                params, cfg, ccfg, calib, budget_kind=budget[0],
                budget_value=budget[1], n_layers=args.layers,
                grid=parse_grid(args.grid), solver=args.solver,
                arch=cfg.name)
            plan_source = "budget"
            if args.emit_plan:
                os.makedirs(os.path.dirname(args.emit_plan) or ".",
                            exist_ok=True)
                plan.save(args.emit_plan)
        if plan is not None:
            # the plan pins everything the seeds + selections depend on
            ccfg = plan.to_cur_config(ccfg)
            layers = plan.layers

    # ---- compress + fold ----------------------------------------------
    t0 = time.perf_counter()
    with prof.scope("compress"):
        cparams, ccfg_model, info = compress_model(
            params, cfg, ccfg, calib, layers=layers, tracer=tracer)
        _sync(device)
    dt = time.perf_counter() - t0
    # fold time is measured inside compress_model (each fold ends in a
    # sync); split the wall span into back-to-back compress/fold spans
    tracer.add_span("compress", t0, dt - info.seconds_fold)
    tracer.add_span("fold", t0 + dt - info.seconds_fold, info.seconds_fold)

    # ---- save ---------------------------------------------------------
    with _stage(tracer, "save", device):
        _save(ckpt_dir, {"params": cparams})

    # ---- draft (self-drafted speculative decoding companion) ----------
    draft_report = None
    if args.emit_draft:
        with _stage(tracer, "draft", device):
            dparams, _, dplan, dinfo = build_draft(params, cfg, calib, args)
            draft_dir = os.path.join(ckpt_dir, "draft")
            _save(draft_dir, {"params": dparams})
            dplan.save(os.path.join(draft_dir, "plan.json"))
        dw = dinfo.weights
        d_before = sum(x.params_before for x in dw)
        d_after = sum(x.params_after for x in dw)
        draft_report = {
            "ckpt_dir": draft_dir,
            "budget_params": args.draft_budget_params,
            "layers_compressed": dinfo.layers,
            "ranks": {rank_key(x.layer, x.name): x.rank for x in dw},
            "params_deployed": d_after,
            "realized_fraction": round(d_after / max(d_before, 1), 6),
            "model_params_saved": dinfo.params_saved,
        }

    # ---- smoke-generate -----------------------------------------------
    with _stage(tracer, "generate", device):
        n_tokens, engine = _smoke_generate(
            cparams, ccfg_model, n_requests=args.n_requests,
            prompt_len=args.prompt_len, new_tokens=args.new_tokens,
            max_concurrency=args.max_concurrency, seed=args.seed,
            device=device)

    stages = tracer.durations(track=obs.ENGINE_TRACK)
    stages["total"] = time.perf_counter() - t_total

    w = info.weights
    before = sum(x.params_before for x in w)
    after_deployed = sum(x.params_after for x in w)
    # realized-vs-requested budget + the per-weight assigned ranks, for
    # every run (uniform runs report requested=None)
    plan_report = {
        "source": plan_source,                    # uniform | budget | file
        "ranks": {rank_key(x.layer, x.name): x.rank for x in w},
        "budget": {
            "kind": plan.budget_kind if plan else "params",
            "requested": plan.budget_requested if plan else None,
            "realized_params": after_deployed,
            "realized_fraction": round(after_deployed / max(before, 1), 6),
            "feasible": plan.feasible if plan else None,
        },
    }
    if plan:
        plan_report["solver"] = plan.solver
        plan_report["provenance"] = dict(plan.provenance)
        plan_report["budget"]["realized"] = dict(plan.realized)
    report = {
        "arch": args.arch,
        "smoke": args.smoke,
        "n_layers": cfg.n_layers,
        "device": str(device),
        "pipeline": args.pipeline,
        "svd": args.svd,
        "selection": args.selection,
        "fold": not args.no_fold,
        "r_max": args.r_max,
        "layers_compressed": info.layers,
        "n_weights": len(w),
        "plan": plan_report,
        "stages_s": {k: round(v, 4) for k, v in stages.items()},
        "params": {
            "model_total": cfg.param_count(),
            "targeted_before": before,
            "after_unfolded": sum(x.params_after_unfolded for x in w),
            "after_folded": sum(x.params_after_folded for x in w),
            "after_deployed": after_deployed,
            "saved_deployed": info.params_saved,
            "saved_unfolded": info.params_saved_unfolded,
            "saved_folded": info.params_saved_folded,
            "reduction_pct_model": round(
                100.0 * info.params_saved / max(cfg.param_count(), 1), 3),
        },
        "weights": [{
            "layer": x.layer, "name": x.name, "shape": list(x.shape),
            "rank": x.rank,
            "rel_fro_err": round(x.fro_err / max(x.fro_w, 1e-30), 6),
            "bound": None if np.isnan(x.bound) else round(x.bound, 4),
            "bound_on": x.bound_on,
            "seconds": round(x.seconds, 5),
        } for x in w],
        "generate": {"tokens": n_tokens, "engine": engine,
                     "tok_per_s": round(n_tokens / max(
                         stages["generate"], 1e-9), 1)},
    }
    if draft_report is not None:
        report["draft"] = draft_report
    return CureRun(report, cfg, params, ccfg_model, cparams, calib, info)


def cure(args, *, tracer=None) -> dict:
    """Run the pipeline and return its report."""
    return cure_run(args, tracer=tracer).report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    choices=list(ARCHS + PORT_ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=2,
                    help="CUR-compress this many layers (angular choice)")
    ap.add_argument("--r-max", type=int, default=32)
    ap.add_argument("--selection", default="wanda_deim",
                    choices=("wanda_deim", "wanda", "deim", "weight",
                             "random"))
    ap.add_argument("--svd", default="randomized",
                    choices=("exact", "randomized"))
    ap.add_argument("--pipeline", default="batched",
                    choices=("batched", "loop"))
    ap.add_argument("--no-fold", action="store_true",
                    help="deploy {C,U0,dU,R} (healing form) instead of "
                         "the folded {CU,R}")
    # budget-driven planning (repro_torch.plan)
    ap.add_argument("--plan", default=None,
                    help="execute a saved CompressionPlan JSON (pins "
                         "ranks/layers/selection/svd/seed — reproduces "
                         "the emitting run's exact selections)")
    ap.add_argument("--budget-params", type=float, default=None,
                    help="<=1: fraction of targeted dense params; >1: "
                         "absolute count — allocates per-weight ranks")
    ap.add_argument("--budget-bytes", type=float, default=None)
    ap.add_argument("--budget-latency-ms", type=float, default=None,
                    help="absolute H100 roofline milliseconds")
    ap.add_argument("--solver", default="greedy", choices=("greedy", "dp"))
    ap.add_argument("--grid", default=None,
                    help="comma-separated planning rank grid")
    ap.add_argument("--emit-plan", default=None,
                    help="write the allocated plan JSON here (budget "
                         "runs only)")
    # speculative-decoding draft companion
    ap.add_argument("--emit-draft", action="store_true",
                    help="also compress the SAME checkpoint to a "
                         "plan-allocated budget and save it under "
                         "<ckpt-dir>/draft (serve with --draft "
                         "<ckpt-dir>/draft)")
    ap.add_argument("--draft-budget-params", type=float, default=0.35,
                    help="draft parameter budget (fraction of targeted "
                         "dense params)")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="layers to compress in the draft "
                         "(default: --layers)")
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--calib-batch", type=int, default=2)
    ap.add_argument("--calib-len", type=int, default=64)
    ap.add_argument("--n-requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-concurrency", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default results/cure/<arch>")
    ap.add_argument("--report", default=None,
                    help="write the per-stage timing/params/error JSON here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # observability (repro_torch.obs)
    ap.add_argument("--obs", action="store_true",
                    help="enable the process-wide metrics registry and "
                         "write metrics.json/.prom to --obs-out")
    ap.add_argument("--obs-out", default="results/obs/cure",
                    help="directory for obs artifacts")
    ap.add_argument("--trace", action="store_true",
                    help="write a Chrome/Perfetto trace.json of the "
                         "stage spans to --obs-out")
    ap.add_argument("--prof", action="store_true",
                    help="capture a torch.profiler trace of calibrate "
                         "and compress under --obs-out/torchprof")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    tracer = obs.Tracer(
        enabled=True, process="repro_torch.cure") if args.trace else None
    report = cure(args, tracer=tracer)
    if args.obs or args.trace:
        written = obs.write_all(
            args.obs_out,
            registry=obs.default_registry() if args.obs else None,
            tracer=tracer)
        for kind, path in written.items():
            print(f"  obs {kind} -> {path}")
    s, p = report["stages_s"], report["params"]
    print(f"cured {args.arch}{' (smoke)' if args.smoke else ''} on "
          f"{report['device']}: {report['n_weights']} weights in layers "
          f"{report['layers_compressed']}")
    print("  " + "  ".join(f"{k}={s[k]:.3f}s" for k in
                           ("init", "calibrate", "plan", "compress",
                            "fold", "save", "draft", "generate", "total")
                           if k in s))
    if "draft" in report:
        d = report["draft"]
        print(f"  draft: {d['params_deployed']/1e3:.0f}k params "
              f"(fraction {d['realized_fraction']:.3f}) ranks "
              f"{d['ranks']} -> {d['ckpt_dir']}")
    pl = report["plan"]
    if pl["source"] != "uniform":
        b = pl["budget"]
        print(f"  plan[{pl['source']}/{pl.get('solver', '?')}] "
              f"budget[{b['kind']}]: requested {b['requested']:.4g} -> "
              f"realized fraction {b['realized_fraction']:.3f} "
              f"ranks {pl['ranks']}")
    print(f"  params: targeted {p['targeted_before']/1e3:.0f}k -> "
          f"deployed {p['after_deployed']/1e3:.0f}k "
          f"(folded {p['after_folded']/1e3:.0f}k / unfolded "
          f"{p['after_unfolded']/1e3:.0f}k); "
          f"model reduction {p['reduction_pct_model']:.2f}%")
    worst = max(report["weights"], key=lambda x: x["rel_fro_err"],
                default=None)
    if worst:
        print(f"  worst rel fro err: {worst['rel_fro_err']:.4f} "
              f"(layer {worst['layer']} {worst['name']})")
    g = report["generate"]
    print(f"  generated {g['tokens']} tokens via {g['engine']} "
          f"({g['tok_per_s']:.1f} tok/s)")
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"  report -> {args.report}")
    return report


if __name__ == "__main__":
    main()
