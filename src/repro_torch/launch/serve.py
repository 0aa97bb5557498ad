"""Serving entry point: continuous-batching runtime over an (optionally
CUR-compressed) model with a paged, optionally CUR-compressed KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \
      --smoke --cur-kv --device cpu

``--smoke`` drives a mixed workload -- ragged prompt lengths, staggered
arrivals, per-request generation budgets -- through
``repro_torch.serving.Server``. On a CUDA device (the default) decode
attention runs the ``paged_attention`` kernel and prefill the
``flash_attention`` and ``cur_matmul`` kernels.

Speculative decoding with a self-draft (the draft pool is new, the
weights are the target's):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \
      --smoke --draft self:2 --spec-k 3 --device cpu

A draft checkpoint directory (``--draft DIR``: ``DIR/template.json`` and
the newest valid step, e.g. the save stage of ``repro_torch.launch.cure``)
is restored through ``repro_torch.dist.CheckpointManager``.

``--chaos PLAN.json`` injects a seeded ``repro_torch.testing.FaultPlan``
and writes the fault event log to ``--obs-out/chaos_events.jsonl``.

``--legacy`` runs the static-batch engine (``repro_torch.serve.engine``:
dense KV cache, ``--batch`` SyntheticLM prompts of ``--prompt-len``
tokens). ``--prof`` captures a ``torch.profiler`` trace of the serve loop
under ``--obs-out/torchprof``. ``--paged-kernel auto|on|off`` and
``--prefill-backend auto|fold|reconstruct`` are passed to the ``Server``
as arguments: "off" is the caller's explicit choice of the plain paged
attention on the pool's device, and "on" raises for a CPU pool (the
kernel has no interpret mode).
"""
import argparse
import dataclasses
import math
import os
import time

import numpy as np

from repro_torch import obs, resolve_device
from repro_torch.configs import (
    ARCHS, PORT_ARCHS, get_config, get_smoke)
from repro_torch.configs.base import CURConfig
from repro_torch.core import calibrate, compress_model
from repro_torch.core.compress import unrolled_config
from repro_torch.data.tokens import DataConfig, SyntheticLM
from repro_torch.dist.checkpoint import CheckpointManager, load_tree_template
from repro_torch.models import init_params
from repro_torch.obs import loadgen, slo as slo_mod
from repro_torch.serve.engine import generate
from repro_torch.serving import PagedConfig, ResilienceConfig, Server
from repro_torch.serving.paged_cache import supports as paged_supports
from repro_torch.serving.speculative import early_exit_draft
from repro_torch.testing import ChaosEngine, FaultPlan


def make_workload(n_requests: int, vocab: int, *, max_new: int = 16,
                  seed: int = 0, arrival_spacing_s: float = 0.02):
    """Mixed smoke workload: ragged prompts (8..40 tokens), per-request
    new-token budgets (4..max_new), staggered arrival offsets."""
    rng = np.random.RandomState(seed)
    lo = max(1, min(4, max_new))
    reqs = []
    for i in range(n_requests):
        plen = int(rng.choice([8, 12, 16, 24, 32, 40]))
        n_new = int(rng.randint(lo, max_new + 1))
        reqs.append({
            "prompt": rng.randint(0, vocab, size=plen).tolist(),
            "max_new_tokens": n_new,
            "arrival_offset_s": i * arrival_spacing_s,
        })
    return reqs


def run_continuous(server: Server, workload, *, temperature: float = 0.0,
                   verbose: bool = True):
    """Drive the engine against the workload's virtual-time arrivals
    (open-loop: each request is stamped with its scheduled arrival, so
    injection lateness lands in queue wait). Returns (finished, stats)."""
    loadgen.drive(server, workload, temperature=temperature)
    stats = server.stats()
    if verbose:
        print(f"completed {stats['completed']} requests, "
              f"{stats['tokens_generated']} tokens in "
              f"{stats['elapsed_s']:.2f}s "
              f"({stats['tokens_per_s']:.1f} tok/s)")
        print(f"ttft mean {stats['ttft_mean_s']*1e3:.0f}ms "
              f"max {stats['ttft_max_s']*1e3:.0f}ms | queue depth "
              f"mean {stats['queue_depth_mean']:.1f} "
              f"max {stats['queue_depth_max']} | "
              f"steps prefill={stats['n_prefill_steps']} "
              f"decode={stats['n_decode_steps']} "
              f"preempt={stats['n_preemptions']}")
        print(f"decode phase: {stats['decode_tok_s']:.1f} tok/s "
              f"({stats['decode_time_s']:.2f}s) | gather "
              f"{stats['gathered_bytes_per_step']/2**10:.1f} KiB/step")
        print(f"kv cache: {stats['cache_bytes']/2**20:.2f} MiB")
    return server.finished, stats


def load_draft(directory: str, cfg, device):
    """Restore a draft checkpoint dir (``{"params": ...}`` at its newest
    valid step, structured by ``DIR/template.json``) onto ``device``.
    Returns (step, params, draft cfg). A CURed tree has per-layer groups
    (``compress_model``'s layout), so its cfg is ``cfg`` unrolled; a tree
    with ``cfg``'s groups keeps ``cfg``."""
    template = load_tree_template(os.path.join(directory, "template.json"))
    step, tree = CheckpointManager(directory).restore(template, device=device)
    params = tree["params"]
    if len(params["groups"]) != len(cfg.groups):
        cfg = unrolled_config(cfg)
    return step, params, cfg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    choices=list(ARCHS + PORT_ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="calibration batch of --cur-layers and the "
                         "--legacy batch")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="calibration and --legacy prompt length")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--cur-layers", type=int, default=0,
                    help="CUR-compress this many layers (weights)")
    ap.add_argument("--cur-kv", action="store_true",
                    help="CUR-compress the paged KV cache")
    ap.add_argument("--kv-rank", type=int, default=0,
                    help="CUR-KV rank (0: head_dim // 2)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-concurrency", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--paged-kernel", default="auto",
                    choices=["auto", "on", "off"],
                    help="paged decode attention: the kernel for a CUDA "
                         "pool (auto, on), or the plain version (off); on "
                         "raises for a CPU pool")
    ap.add_argument("--prefill-backend", default=None,
                    choices=["auto", "fold", "reconstruct"],
                    help="CUR-KV prompt attention: rank-space fold "
                         "(auto, fold) or the full-head-dim reconstruct "
                         "oracle")
    ap.add_argument("--legacy", action="store_true",
                    help="static-batch engine (dense KV cache) over "
                         "--batch prompts of --prompt-len tokens")
    ap.add_argument("--draft", default=None,
                    help="speculative decoding: 'self' to self-draft with "
                         "the target weights, 'self:N' for an early-exit "
                         "draft from the target's first N layers, or a "
                         "checkpoint dir with a template.json (e.g. "
                         "cure's --ckpt-dir)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per speculative window")
    ap.add_argument("--draft-kv-rank", type=int, default=0,
                    help="CUR-KV rank for the DRAFT's paged pool "
                         "(0: same pool config as the target)")
    # load generation (repro_torch.obs.loadgen) + SLO evaluation
    ap.add_argument("--arrival", default="staggered",
                    choices=["staggered", "burst", "poisson", "gamma",
                             "bursty", "uniform"],
                    help="arrival process: 'staggered' keeps the fixed-"
                         "spacing smoke workload; the rest are seeded "
                         "loadgen processes driven open-loop at --rate QPS")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="offered rate (requests/s) for loadgen arrivals")
    ap.add_argument("--shared-prefix", type=float, default=0.0,
                    help="fraction of requests sharing one of 4 fixed "
                         "16-token prompt prefixes")
    ap.add_argument("--workload-trace", default=None,
                    help="replay a loadgen JSONL trace instead of "
                         "generating a workload")
    ap.add_argument("--save-trace", default=None,
                    help="save the generated workload as a JSONL trace")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="TTFT target (ms); with --slo-tpot-ms, prints "
                         "SLO attainment + goodput after the run")
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0,
                    help="TPOT target (ms) for the SLO evaluation")
    # resilience (repro_torch.serving.resilience)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the admission queue (0: unbounded)")
    ap.add_argument("--overload-policy", default="reject",
                    choices=["reject", "shed-oldest", "priority"])
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="total per-request deadline (ms from arrival)")
    ap.add_argument("--ttft-deadline-ms", type=float, default=0.0,
                    help="TTFT deadline (ms from arrival)")
    ap.add_argument("--watchdog-s", type=float, default=0.0,
                    help="wall-clock bound per engine step (0: off)")
    ap.add_argument("--chaos", default=None, metavar="PLAN.json",
                    help="inject a seeded FaultPlan (repro_torch.testing."
                         "chaos JSON spec) into the serve run; the fault "
                         "event log is written to "
                         "--obs-out/chaos_events.jsonl")
    # observability (repro_torch.obs)
    ap.add_argument("--obs", action="store_true",
                    help="route serving metrics through the process-wide "
                         "registry and write metrics.json/.prom + "
                         "events.jsonl to --obs-out")
    ap.add_argument("--obs-out", default="results/obs/serve",
                    help="directory for obs artifacts")
    ap.add_argument("--trace", action="store_true",
                    help="record engine + per-request lifecycle spans "
                         "and write a Chrome/Perfetto trace.json")
    ap.add_argument("--prof", action="store_true",
                    help="capture a torch.profiler trace of the serve "
                         "loop under --obs-out/torchprof")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.obs:
        obs.enable()
    tracer = obs.Tracer(enabled=args.trace, process="repro_torch.serve")
    prof = obs.TorchProfiler(
        os.path.join(args.obs_out, "torchprof") if args.prof else None,
        tracer=tracer)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} uses the embeddings stub")
    params = init_params(0, cfg, device)

    if args.cur_layers:
        ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.prompt_len,
                                    global_batch=args.batch), device)
        calib = calibrate(params, cfg, [ds.batch_at(1)])
        params, cfg, info = compress_model(
            params, cfg,
            CURConfig(r_max=32, n_compress_layers=args.cur_layers,
                      fold_u=True),
            calib)
        print(f"CUR-compressed {info.layers} "
              f"({info.params_saved/1e3:.0f}k params saved)")

    if args.legacy or not paged_supports(cfg):
        if not args.legacy:
            print(f"{args.arch}: non-attention mixers -> legacy engine")
        ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.prompt_len,
                                    global_batch=args.batch), device)
        prompts = ds.batch_at(0)["tokens"]
        t0 = time.perf_counter()
        out = generate(params, cfg, prompts, args.new_tokens,
                       temperature=args.temperature)
        toks = out.tokens.cpu()
        dt = time.perf_counter() - t0
        print(f"generated {toks.numel()} tokens in {dt:.2f}s "
              f"({toks.numel()/dt:.1f} tok/s)")
        print(toks[:2])
        return out

    wspec = None
    if args.workload_trace:
        workload = loadgen.load_trace(args.workload_trace)
        print(f"replaying {len(workload)} requests from "
              f"{args.workload_trace}")
    elif args.arrival != "staggered":
        wspec = loadgen.WorkloadSpec(
            n_requests=args.n_requests, rate_qps=args.rate,
            arrival=args.arrival,
            gen=loadgen.LengthDist(kind="fixed", mean=args.new_tokens,
                                   hi=max(1, args.new_tokens)),
            vocab_size=cfg.vocab_size,
            shared_prefix_fraction=args.shared_prefix)
        workload = loadgen.generate(wspec)
        print(f"loadgen: {args.arrival} arrivals at {args.rate:g} rps "
              f"({len(workload)} requests)")
    else:
        workload = make_workload(args.n_requests, cfg.vocab_size,
                                 max_new=args.new_tokens)
    if args.save_trace:
        loadgen.save_trace(args.save_trace, workload, spec=wspec)
        print(f"workload trace -> {args.save_trace}")
    max_len = max(len(r["prompt"]) + r["max_new_tokens"]
                  for r in workload)
    kv_rank = 0
    if args.cur_kv:
        kv_rank = args.kv_rank or max(1, cfg.resolved_head_dim // 2)
    pc = PagedConfig.sized_for(
        max_len, args.max_concurrency, block_size=args.block_size,
        cur_kv=args.cur_kv, kv_rank=kv_rank)
    draft_params, draft_cfg, draft_pc = None, None, None
    if args.draft == "self":
        draft_params = params
    elif args.draft and args.draft.startswith("self:"):
        n = int(args.draft.split(":", 1)[1])
        draft_params, draft_cfg = early_exit_draft(params, cfg, n)
        print(f"early-exit self-draft: first {draft_cfg.n_layers} of "
              f"{cfg.n_layers} layers")
    elif args.draft:
        step, draft_params, draft_cfg = load_draft(args.draft, cfg, device)
        print(f"draft checkpoint {args.draft} (step {step})")
    if draft_params is not None and args.draft_kv_rank:
        draft_pc = dataclasses.replace(pc, cur_kv=True,
                                       kv_rank=args.draft_kv_rank)
    res = ResilienceConfig(
        max_queue=args.max_queue, overload_policy=args.overload_policy,
        ttft_deadline_s=args.ttft_deadline_ms / 1e3,
        deadline_s=args.deadline_ms / 1e3, watchdog_s=args.watchdog_s)
    chaos = None
    if args.chaos:
        chaos = ChaosEngine(FaultPlan.load(args.chaos))
        print(f"chaos: {len(chaos.plan.faults)} fault streams "
              f"(seed {chaos.plan.seed}) from {args.chaos}")
    server = Server(params, cfg, pc, max_concurrency=args.max_concurrency,
                    draft_params=draft_params, draft_cfg=draft_cfg,
                    draft_pc=draft_pc,
                    spec_k=args.spec_k if draft_params is not None else 0,
                    obs=obs.default_registry() if args.obs else None,
                    tracer=tracer, resilience=res, chaos=chaos,
                    device=device, paged_kernel=args.paged_kernel,
                    prefill_backend=args.prefill_backend)
    print(f"serving {len(workload)} requests on {device} "
          f"(concurrency {args.max_concurrency}, block {args.block_size}, "
          f"pool {pc.n_blocks} blocks, cur_kv={args.cur_kv}, "
          f"paged_decode={server.stats()['attn_backends']['paged_decode']}, "
          f"prefill={server._prefill_backend}"
          + (f", window={server.window}" if server.window else "")
          + (f", spec_k={server.spec_k}" if server.spec_k else "") + ")")
    with prof.scope("serve"):
        finished, stats = run_continuous(server, workload,
                                         temperature=args.temperature)
    if chaos is not None:
        # close any open fault windows (held pool squeezes) and finish
        # whatever the faults displaced, then refresh the report
        chaos.finish(server)
        server.drain()
        stats = server.stats()
    failed = stats.get("failed", {})
    if any(failed.values()) or stats.get("degradation_transitions"):
        print(f"resilience: failed {failed} | degradation level "
              f"{stats['degradation_level']} "
              f"({stats['degradation_transitions']} transitions) | "
              f"step faults {stats['step_faults']}")
    print(f"slo: ttft p50 {stats['ttft_p50_s']*1e3:.0f}ms "
          f"p99 {stats['ttft_p99_s']*1e3:.0f}ms | tpot "
          f"p50 {stats['tpot_p50_s']*1e3:.1f}ms "
          f"p99 {stats['tpot_p99_s']*1e3:.1f}ms | queue-wait "
          f"p50 {stats['queue_wait_p50_s']*1e3:.0f}ms "
          f"p99 {stats['queue_wait_p99_s']*1e3:.0f}ms | "
          f"busy {stats['tokens_per_s_busy']:.1f} tok/s "
          f"(wall {stats['tokens_per_s']:.1f})")
    if args.slo_ttft_ms or args.slo_tpot_ms:
        spec = slo_mod.SLOSpec(
            ttft_s=args.slo_ttft_ms / 1e3 or math.inf,
            tpot_s=args.slo_tpot_ms / 1e3 or math.inf)
        rep = slo_mod.evaluate(finished.values(), spec,
                               stats["elapsed_s"])
        dec = slo_mod.decompose_stats(stats)
        print(f"slo spec (ttft<={args.slo_ttft_ms:g}ms, "
              f"tpot<={args.slo_tpot_ms:g}ms): attainment "
              f"{rep.attainment:.3f} ({rep.n_meeting}/{rep.n_requests})"
              f" | goodput {rep.goodput_tok_s:.1f} tok/s "
              f"(throughput {rep.throughput_tok_s:.1f})")
        print(f"latency split: queue {dec['queue_wait_frac']:.0%} "
              f"prefill {dec['prefill_frac']:.0%} "
              f"decode {dec['decode_frac']:.0%}")
    if server.spec_k:
        print(f"speculative: accept rate "
              f"{stats['spec_accept_rate']:.3f} over "
              f"{stats['n_spec_windows']} windows "
              f"({stats['n_spec_fallbacks']} fallbacks) | draft "
              f"{stats['spec_draft_time_s']:.2f}s verify "
              f"{stats['spec_verify_time_s']:.2f}s")
    first = finished[min(finished)]
    print(f"request 0: {len(first.out_tokens)} tokens "
          f"{first.out_tokens[:8]}"
          f"{'...' if len(first.out_tokens) > 8 else ''}")
    for path in prof.paths:
        print(f"  profiler trace -> {path}")
    if chaos is not None and chaos.events:
        os.makedirs(args.obs_out, exist_ok=True)
        path = chaos.save_events(
            os.path.join(args.obs_out, "chaos_events.jsonl"))
        print(f"  chaos events ({len(chaos.events)}) -> {path}")
    if args.obs or args.trace:
        os.makedirs(args.obs_out, exist_ok=True)
        if args.obs:
            log = obs.JsonlLog(os.path.join(args.obs_out, "events.jsonl"))
            for rid in sorted(finished):
                r = finished[rid]
                log.log("request", rid=rid, tokens=len(r.out_tokens),
                        ttft_s=r.ttft, reason=r.finish_reason,
                        preempted=r.n_preempted)
            log.log("stats", **stats)
            log.close()
            print(f"  obs events -> {log.path}")
        written = obs.write_all(
            args.obs_out, registry=server.obs if args.obs else None,
            tracer=tracer)
        for kind, path in written.items():
            print(f"  obs {kind} -> {path}")
    return stats


if __name__ == "__main__":
    main()
