"""One-shot CURing on the GPU: the end-to-end compression pipeline.

    PYTHONPATH=src python -m repro_torch.launch.cure --arch llama3.1-8b \
        --layers 10 --r-max 256 --report results/cure/llama.json

Stages (each timed on the host clock, ending in a device synchronise):
init (random params made on the device) -> calibrate -> plan (uniform
ranks only) -> compress (batched shape-class pipeline by default) -> fold
C@U -> save (``dist.CheckpointManager``, step 0 of ``--ckpt-dir``, with
its ``template.json``) -> smoke-generate through ``repro_torch.serving``
(the static-batch engine for archs the paged runtime does not take). The
report keeps the JAX launcher's schema (``stages_s``, ``params.*``,
``weights[]``, ``layers_compressed``, ``generate``); ``stages_s.total``
covers every stage, save and generate included.

Not ported yet (they raise): budget planning (``--plan``,
``--budget-*``, ``--emit-plan``) and the draft companion
(``--emit-draft``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import CURConfig, ModelConfig
from repro_torch.core import calibrate, compress_model
from repro_torch.core.compress import rank_key
from repro_torch.data.tokens import DataConfig, SyntheticLM
from repro_torch.dist.checkpoint import CheckpointManager, save_tree_template
from repro_torch.models import init_params
from repro_torch.serve.engine import generate
from repro_torch.serving import PagedConfig, SamplingParams, Server
from repro_torch.serving.paged_cache import supports as paged_supports


@dataclasses.dataclass
class CureRun:
    """A finished run: its report and both models (original and CURed)."""
    report: dict
    cfg: ModelConfig
    params: Any
    cured_cfg: ModelConfig
    cured_params: Any


def _not_ported(args) -> None:
    budget = any(v is not None for v in (
        args.budget_params, args.budget_bytes, args.budget_latency_ms))
    later = [("--plan", args.plan), ("--budget-*", budget),
             ("--emit-plan", args.emit_plan),
             ("--emit-draft", args.emit_draft)]
    for flag, value in later:
        if value:
            raise NotImplementedError(
                f"{flag} is not yet ported to repro_torch (ROADMAP Queue 1)")


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


class _Stages:
    """Wall time of each stage, each ending in a device synchronise."""

    def __init__(self, device):
        self.device = device
        self.seconds = {}

    def run(self, name, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = time.perf_counter() - t0
        return out


def cure_run(args) -> CureRun:
    _not_ported(args)
    device = resolve_device(args.device)
    stages = _Stages(device)
    t_total = time.perf_counter()

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} uses the embeddings stub")
    params = stages.run("init", lambda: init_params(args.seed, cfg, device))

    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=args.calib_len,
                                global_batch=args.calib_batch,
                                seed=args.seed), device)
    batches = [ds.batch_at(i) for i in range(args.calib_batches)]
    calib = stages.run("calibrate", lambda: calibrate(params, cfg, batches))

    ccfg = CURConfig(r_max=args.r_max, n_compress_layers=args.layers,
                     selection=args.selection, svd=args.svd,
                     fold_u=not args.no_fold, pipeline=args.pipeline,
                     seed=args.seed)
    stages.seconds["plan"] = 0.0          # uniform ranks: nothing to plan

    t0 = time.perf_counter()
    cparams, ccfg_model, info = compress_model(params, cfg, ccfg, calib)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    stages.seconds["compress"] = dt - info.seconds_fold
    stages.seconds["fold"] = info.seconds_fold

    def save():
        out = args.ckpt_dir or os.path.join("results", "cure", args.arch)
        CheckpointManager(out, keep_n=1).save(0, {"params": cparams})
        save_tree_template(os.path.join(out, "template.json"),
                           {"params": cparams})

    stages.run("save", save)
    n_tokens, engine = stages.run("generate", lambda: _smoke_generate(
        cparams, ccfg_model, n_requests=args.n_requests,
        prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        max_concurrency=args.max_concurrency, seed=args.seed,
        device=device))
    stages.seconds["total"] = time.perf_counter() - t_total

    w = info.weights
    before = sum(x.params_before for x in w)
    after_deployed = sum(x.params_after for x in w)
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
        "plan": {
            "source": "uniform",
            "ranks": {rank_key(x.layer, x.name): x.rank for x in w},
            "budget": {
                "kind": "params", "requested": None,
                "realized_params": after_deployed,
                "realized_fraction": round(
                    after_deployed / max(before, 1), 6),
                "feasible": None,
            },
        },
        "stages_s": {k: round(v, 4) for k, v in stages.seconds.items()},
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
                         stages.seconds["generate"], 1e-9), 1)},
    }
    return CureRun(report, cfg, params, ccfg_model, cparams)


def cure(args) -> dict:
    """Run the pipeline and return its report."""
    return cure_run(args).report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(ARCHS))
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
    ap.add_argument("--plan", default=None, help="not yet ported")
    ap.add_argument("--budget-params", type=float, default=None,
                    help="not yet ported")
    ap.add_argument("--budget-bytes", type=float, default=None,
                    help="not yet ported")
    ap.add_argument("--budget-latency-ms", type=float, default=None,
                    help="not yet ported")
    ap.add_argument("--emit-plan", default=None, help="not yet ported")
    ap.add_argument("--emit-draft", action="store_true",
                    help="not yet ported")
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
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    report = cure(args)
    s, p = report["stages_s"], report["params"]
    print(f"cured {args.arch}{' (smoke)' if args.smoke else ''} on "
          f"{report['device']}: {report['n_weights']} weights in layers "
          f"{report['layers_compressed']}")
    print("  " + "  ".join(f"{k}={s[k]:.3f}s" for k in
                           ("init", "calibrate", "plan", "compress",
                            "fold", "save", "generate", "total")))
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
