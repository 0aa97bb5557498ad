#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``. Phases, each on its own lines; any failure exits
nonzero:

  1. card     name, power limit, torch/CUDA versions; TF32 off
  2. build    every kernel of the main path, from ``src/repro_torch/csrc``
  3. kernels  each kernel against its plain PyTorch version (both bodies
              of cur_matmul; bit-identical repeats), scale-relative
              max error < 2e-5 (f32) / < 2e-2 (bf16); paged_attention
              < 1e-5 / 2e-2 (tests/test_paged_attention.py's bounds), on
              that file's grid and on split tables (dead splits, windows
              inside a split, q_span, r 8 .. 256, bs 4 .. 32); the
              flash kernel's zero-padded feature dims (CUR-KV ranks);
              the speculative verify shapes: paged_attention at q_span
              2 / 5 / 8 (G' 8 / 20 / 32) on split tables with ragged
              contexts, cur_matmul at M 40 (8 slots x 5 positions);
              flash_attention under autograd (FlashAttentionFn: the
              kernel's forward, the plain backward): dq / dk / dv against
              autograd through the plain forward over d 16 .. 128, G 1 /
              2 / 4, window 0 / 8, ragged S, f32 and bf16; cur_matmul_op
              and paged_attention_op raise under grad; the backward's time
              at the olmo-1b train and llama3.1-8b heal shapes beside
              SDPA's backward; cur_matmul at the ranks a plan assigns (r
              16 / 32 / 64 / 128 / 512 on the three full-width classes,
              M 2048 and M 40, bf16); the families' shapes, as entries
              of the same grids: cur_matmul at jamba's and mamba2's w_x
              and mixtral's wq / wk, each at the row counts phase 11
              gives it (M 2 to 18,624), flash_attention at head dim 256
              (windows 0 / 8 / 512, G 1 / 4, ragged S, f32 and bf16, and
              through the registry's adaptor from d 160), paged_attention
              at gemma3's r 256 and mixtral's window 4096, and the same
              f32 inputs without the softmax scale against an f64 result
              (1e-5)
  4. times    kernel, plain version and one library call at the main
              paths' shapes (median of 25 launches, CUDA events), beside
              the least time the card could take (bound), with achieved
              GB/s and TFLOP/s and the host's time per call; each
              kernel's registers and spills from the -Xptxas -v log;
              the verify shapes (paged_attention q_span 5, cur_matmul
              M 40) and the planned ranks (cur_matmul r 16 .. 512, M 2048
              and 40, beside the torch.matmul chain) on lines of their own;
              every line also by device_ms; the families' shapes in the
              same loops (cur_matmul at the w_x classes and mixtral's wq
              / wk, at M 2048 and mixtral's served prefill, beside the
              chain; flash_attention at gemma3-1b's d 256 and mixtral's
              window beside SDPA with the window mask; paged_attention at
              r 256 and window 4096 beside SDPA on the gathered pool with
              the window mask)
  5. small    the folded forward at a small f32 size on the card against
              the same params on the CPU (plain versions), 2e-5; then
              that model served on the card and on the CPU, dense and
              CUR-KV pools: the greedy tokens must be identical; the
              original model served with speculation (k 3, draft self
              and self:1): card spec-on == card spec-off == CPU spec-on;
              a fixed chaos plan (transient prefill/decode errors, a
              pool squeeze, latency spikes): the chaos-free tokens and
              the same fault events on the card and the CPU; the dense
              cache's prefill / decode_step logits card vs CPU (2e-5),
              ``generate``'s greedy tokens card == CPU == the Server's,
              the Server with ``paged_kernel="off"`` on the card (the
              kernel's tokens, no launch), and a checkpoint saved from
              the card restored on the CPU bit-identical; a SMOKE train
              step's loss and gradients and a heal step's KD loss and dU
              gradients card vs CPU (2e-5); a REPRO ``train()`` resumed
              from its step-3 checkpoint gives the uninterrupted run's
              losses (2e-5 on the card, bitwise on the CPU)
  6. main     ``cure()`` on full-width llama3.1-8b (random weights made on
              the card, 10 of 32 layers CURed at r_max 256, saved to
              ``build/chip_smoke_ckpt`` and smoke-generated through the
              Server), run ``CURE_RUNS`` times: the first (cold) run's
              stage times alone, then the median and range of the
              others, the checkpoint's bytes and save GB/s (the free
              disk is checked first); after the last run, perplexity of
              the original and the folded model, the launch counts over
              that run, and the checkpoint restored onto the card
              through serve's ``--draft DIR`` function: every leaf and
              the folded logits bit-equal; the directory is deleted
  7. serve    the last run's CURed model served by ``Server`` on the card
              (max_concurrency 8, block 16): workload A (the serve CLI's
              ``make_workload``) and workload B (loadgen burst, prompts
              256/512/1024, 64 new tokens), each on a dense pool and a
              CUR-KV pool at rank 64; per run tokens/s, TTFT, TPOT, pool
              bytes and the launches of all three kernels, with checks;
              then speculative serving at spec_k 4: (a) the original
              model drafted by the CURed one (workload B, dense pool,
              greedy, against its spec-off run), (a') (a) with the draft
              restored from phase 6's checkpoint (the same tokens and
              accept rate), (b) the CURed model drafted by itself
              (workload B, CUR-KV pool r 64), (c) (a) on workload A at
              temperature 0.8, top-p 0.95; accept rate, windows,
              draft/verify time, launches and the agreement with
              spec-off; then a chaos plan on workload A run twice (same
              events, every request finished, pool drained); the
              static-batch engine (serve --legacy's ``generate``, 8 x
              512-token prompts, 64 new tokens): prefill / decode times,
              logits against ``forward()`` (2e-2), kernels launched in
              its prefill, agreement with the Server; last a profiled
              decode window
  8. split    device time by kernel (after every timed phase; CUDA events
              around calls queued behind a spin kernel, cur_matmul's
              passes from torch.profiler, "not measured" when a capture
              lost records): cur_matmul per weight and pass against the
              torch.matmul chain, flash_attention and paged_attention
              against SDPA (also at the verify shape), cur_matmul at the
              planned ranks against the chain, and one traced
              folded perplexity pass (busy and idle share, top kernels);
              one speculative window of run (a) profiled by part (draft,
              verify, paged_attention at q_span 5) and its host syncs;
              serve --prof's ``TorchProfiler.scope`` around one decode
              window: its Chrome trace names paged_attention's kernel
              and the tracer holds the ``prof:`` events; one olmo-1b
              train step (phase 9a's path) and one llama3.1-8b heal step
              (phase 9b's) traced: busy and idle share, top kernels
  9. train    (before phase 8, which stays last) olmo-1b at full width:
              eight steps of the train CLI's path (batch 8 x 128): losses,
              step ms, peak memory, flash_attention launches (16 a step),
              every weight moved; llama3.1-8b healing at full width:
              phase 6's dense model CURed in healing form (its 10 layers,
              r_max 256), eight dU-only KD steps (batch 2 x 512): KD
              losses, step ms, peak memory, 1,966,080 trainable
              parameters, frozen leaves unchanged and every dU moved,
              step 0's dU gradients kernel vs plain attention route
              (2e-2), 32 + 32 flash_attention launches a step; the trained
              REPRO pipeline (zoo, 300 steps, into build/ and deleted):
              perplexity trained / CURed (3 layers, r_max 64, folded,
              cur_matmul) / healed (40 steps), and the trained model's
              speculative accept rate at draft self:2, spec_k 4
 10. plan     (after 9, before 8) budget-driven planning: (a) plan_for_model
              on phase 6's llama3.1-8b (its params, calibration and 10
              layers, exact SVD, grid 4 .. 512) at the uniform
              allocation's deployed params, greedy and dp: profile
              seconds per class, allocate seconds, rank histograms, peak
              memory; the greedy plan executed (every one of the 30
              weights' profiled rel_err within 1e-4 of compress_model's),
              its folded perplexity beside the uniform's and cur_matmul's
              launches by rank; (b) a --budget-latency-ms plan at the
              uniform allocation's H100 roofline ms (realized <=
              requested); (c) cure --emit-draft's draft in memory
              (--draft-budget-params 0.35 over all 30 interior layers),
              its deployed fraction of the target, served on phase 7's
              run-(a) workload at spec_k 4 (accept rate, tok/s beside run
              (a)'s); (d) the plan CLI and cure --plan / --emit-draft at
              --smoke on the card with --obs and --trace; (e)
              progressive_cure on 9c's trained model (budget 0.3, 3
              layers, 2 rounds, 20 heal steps) on the card and then, in a
              process of its own (so that no timed part shares the host),
              on the CPU (f32, the same tokens): the same layers, ranks, accept
              flags and early stop, perplexities within 1e-3
 11. families (after 10, before 8) the other model families, each model
              freed before the next, each part's launches counted from 0:
              (a) the SMOKE configs of jamba, mixtral, kimi, mamba2 and
              gemma3 in f32, params from one seed made on the CPU:
              forward card vs CPU (2e-5), cure_run at --layers 2 --svd
              exact on both (the same layers and DEIM indices), the
              greedy tokens of the engine (jamba, mamba2) or the Server
              card == CPU; (b) jamba-v0.1-52b at full width, one period
              (8 of 32 layers, 13,267,540,608 params, bf16): cure_run at
              --layers 6, r_max 256 on 4 x 4 x 512 tokens (saved to
              build/chip_smoke_family, deleted), saved_deployed against
              the count from the shapes, perplexity original and folded
              and the folded pass's time, one folded forward traced by
              layer kind (moe_dense, mamba block, SSD scan, attention,
              MLP, cur_matmul), the engine's decode logits against
              forward() at steps 1 / 16 / 63: in bf16 printed, with the
              top-k flips against the forward's routing and again with
              the forward's routing held (the recurrent decode rounds
              otherwise than the chunked scan in the JAX package too,
              which tests/test_torch_family_decode.py holds on the CPU),
              and held at 2e-2 on the model cast to f32; (c)
              mixtral-8x22b at full width, 4 of 56 layers: cure_run at
              --layers 2, the Server on 4 prompts of 4,160-4,608 tokens
              (windowed flash_attention and paged_attention, blocks
              evicted behind the 4096 window), one request's prefill and
              decode logits through the paged runtime against forward():
              in bf16 every step past 2e-2 must come at or after a top-k
              flip against the forward's routing, and with that routing
              held the logits must be within 2e-2; in f32 within 2e-2;
              (d) mamba2-1.3b at full size: cure_run at --layers 8 (the
              engine's generate stage), decode logits against forward()
              (bf16 printed, f32 held at 2e-2); (e)
              gemma3-1b at full size: one forward through
              flash_attention at d 256, the paged runtime at r 256 past
              the 512 window against forward(), the Server
 12. dist     (after 11, before 8) the distributed layer at world size 1:
              an NCCL process group (a FileStore under build/) and a 1 x 1
              ("data", "model") mesh; (a) mixtral-8x22b at its own widths,
              2 of 56 layers, bf16, layer 1's wq / wk CURed (r_max 256,
              folded): forward and loss_fn under the mesh (moe_impl
              "a2a": the routed expert-parallel body) against mesh=None
              (moe_dense) at capacity 8.0 (2e-2), at 1.25 the assignments
              dropped; both forwards' device ms, one layer's a2a body
              against moe_dense alone at 4 x 512 tokens and the a2a body
              at 1 x 65,536; generate() under the mesh == mesh=None in
              f32; (b) olmo-1b in f32 (phase 9a's batch): the meshed train
              step and EF step (compressed_psum's all-gather) against the
              unmeshed ones (losses within 2e-5; bitwise printed); (c)
              compressed_psum == dq8(q8(x)) bit for bit; (d) each NCCL
              call the collective funnels make (they skip one-rank
              groups) once over each one-rank group, bf16 and f32: each
              equal to its operand
 13. placed   (after 12, before 8) sharded training at world size 1 (an
              NCCL group on phase 12's FileStore, a 1 x 1 mesh): (a)
              olmo-1b uncut in f32 at phase 9a's batch (8 x 128) and a
              masked, ragged copy of it: 2 steps of the placed step (the
              params and moments placed by the caller) against the
              unmeshed step and the replicated-input meshed step, plain
              and EF (losses within 2e-5, step ms); (b) remat off /
              "full" / "save_mixer_outputs" on the placed step at 4 x
              2048 tokens: loss and every gradient equal across the three
              (2e-5), peak memory (max_memory_allocated) of the gradient
              pass and of a whole step, step ms, flash_attention launches
              (a recomputed forward launches the kernel again); (c)
              restore(shardings=) of 13a's placed params equals
              restore(device="cuda") bit for bit; (d) olmo-1b with 4
              layers' wq, wk and w_gate CURed (folded): the placed
              forward against the unplaced one in bf16 and f32, under
              no_grad and in grad mode, cur_matmul once a folded weight
 14. serving  (after 13, before 8) placed serving at world size 1 (an
              NCCL group on phase 12's FileStore, a 1 x 1 mesh; params
              placed by param_pspecs, caches by cache_pspecs, pools by
              paged_cache_pspecs): (a) generate() on phase 6's CURed
              llama3.1-8b, 8 x 512 prompts, 64 new tokens, placed against
              mesh=None: tokens, logprobs and a prefill / decode step's
              logits bit-equal, equal launches of every kernel; (b) the
              same model through Server(mesh=) on workload A (all
              requests submitted at once) with a dense pool, a CUR-KV r 64
              pool and spec_k 4 drafted by itself, each against
              Server(mesh=None): equal tokens and launches, tok/s; (c)
              mamba2-1.3b uncut through the placed engine, bit-equal; (d)
              the dry run (llama3.1-8b, train_4k and decode_32k --paged
              --cur, the fake 16 x 16 mesh) in a process of its own,
              after (a)-(c): its roofline lines (modelled), no tensor on
              the card (memory_allocated 0), no kernel launched; the
              context PyTorch makes there for fake CUDA tensors is
              reported (nvidia-smi)

The last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``; the line before them is the kernel table.
``--phases 1,2,3`` runs only the phases named (for a first check of a new
kernel; phase 9 without 6 makes llama3.1-8b's weights itself, phase 10
needs 6 and trains its REPRO model without 9, phase 11 needs none of the
others: ``--phases 1,2,11``, nor do 12 and 13: ``--phases 1,2,12,13``;
14 without 6 CURs llama3.1-8b itself, without the save: ``--phases
1,2,14``); the kernel table and the last line need every phase.
"""
import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense tensor-core peak, bf16
F32_TOL, BF16_TOL = 2e-5, 2e-2  # tests/test_kernels.py::_assert_close
PAGED_F32_TOL = 1e-5            # tests/test_paged_attention.py::_assert_close

CUR_SHAPES = {"wq": (4096, 256, 4096), "wk": (4096, 256, 1024),
              "w_gate": (4096, 256, 14336)}   # (m, r, n) at r_max 256
CUR_M = 2048                                  # 4 x 512 tokens
FLASH_SHAPE = (4, 32, 8, 512, 128)            # B, H, K, S, d
CURE_RUNS = 2                                 # 1 cold + 1 warm cure() run
ENGINE_SHAPE = (8, 512, 64)                   # B, prompt, new (legacy engine)
ENGINE_CHECK_STEPS = (1, 16, 63)              # decode steps held to forward()
# cure()'s save stage (git-ignored; deleted at phase 6's end)
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
PAGED_SHAPE = (8, 8, 4, 16, 69)               # B, K, G, bs, maxb (serving)
KV_RANK = 64                                  # CUR-KV pool rank, hd / 2
# workload B's decode contexts (prompts 256 / 512 / 1024 + up to 64 tokens)
RAGGED_CTX = (256, 375, 494, 613, 732, 851, 970, 1088)
SPEC_K = 4                                    # draft tokens per window
ZOO_STEPS = 300                               # phase 9c's zoo training
VERIFY_SPANS = (2, SPEC_K + 1, 8)             # q_span = k + 1 at k 1, 4, 7
VERIFY_M = 8 * (SPEC_K + 1)                   # verify rows: 8 slots x 5
# cur_matmul ranks of a plan at full width (10a's grid 4 .. 512; 256 is
# CUR_SHAPES' and 4 / 8 take the chain)
PLAN_RANKS = (16, 32, 64, 128, 512)
PLAN_R_MAX = 512                              # phase 10a's grid, 4 .. 512
DRAFT_LAYERS = 30                             # phase 10c: every interior one
# phase 10e: progressive_cure on the trained REPRO model (card and CPU)
PROG = {"budget_kind": "params", "budget_value": 0.3, "n_layers": 3,
        "rounds": 2, "heal_steps": 20}
PROG_GAP = 1e-3                               # card vs CPU perplexity, rel
# phase 10's files (git-ignored; deleted at its end)
PLAN_DIR = os.path.join(ROOT, "build", "chip_smoke_plan")
# phase 5's chaos plan (a repro_torch.testing.FaultPlan as JSON)
CHAOS_PLAN = {"seed": 11, "faults": [
    {"kind": "transient_error", "start_step": 1, "end_step": 3,
     "site": "prefill"},
    {"kind": "transient_error", "start_step": 4, "end_step": 24,
     "probability": 0.5, "site": "decode"},
    {"kind": "pool_squeeze", "start_step": 5, "end_step": 12,
     "magnitude": 0.5},
    {"kind": "latency_spike", "start_step": 2, "end_step": 8,
     "probability": 0.5, "magnitude": 0.002}]}
# phase 7's: the same streams and a queue storm
CHAOS_PLAN_7 = {"seed": 5, "faults": CHAOS_PLAN["faults"] + [
    {"kind": "queue_storm", "start_step": 6, "end_step": 7, "n": 3}]}

# this slice's full-width shapes (phases 3 and 4). cur_matmul: (m, r, n)
# and the row counts phase 11 gives each class: calibration 4 x 512, the
# engine's prefill 2 x 256 and decode 2 (jamba, mamba2); mixtral's one
# request of 4160, the Server's prefill of 4 slots x 4656 (the bucket is
# the pool's max_len) and its decode of 4 slots
MIXTRAL_SERVED_M = 4 * 4656
FAMILY_CUR = {"jamba w_x": ((4096, 256, 8192), (CUR_M, 512, 2)),
              "mamba2 w_x": ((2048, 256, 4096), (CUR_M, 512, 2)),
              "mixtral wq": ((6144, 256, 6144),
                             (CUR_M, 4160, MIXTRAL_SERVED_M, 4)),
              "mixtral wk": ((6144, 256, 1024),
                             (CUR_M, 4160, MIXTRAL_SERVED_M, 4))}
# B, H, K, S, d, window: gemma3-1b's local layers, mixtral's prefill
FAMILY_FLASH = {"gemma3 d 256": (4, 4, 1, 1024, 256, 512),
                "mixtral window": (1, 48, 8, 4608, 128, 4096)}
# B, K, G, r, bs, ctx, window: gemma3's decode (r = hd 256, a local layer)
# and mixtral's (the window behind the longest prompt)
FAMILY_PAGED = {"gemma3 r 256": (3, 1, 4, 256, 16, (700, 600, 800), 512),
                "mixtral window": (4, 8, 6, 128, 16,
                                   (4191, 4383, 4511, 4639), 4096)}


def say(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_used_mib():
    """The card's memory in use by every process (nvidia-smi), MiB."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return int(out.stdout.strip().splitlines()[0])


def rel_err(y, yr):
    y, yr = y.float(), yr.float()
    return float((y - yr).abs().max() / (yr.abs().max() + 1e-9))


def median_ms(fn, n=25, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ptxas_report(name):
    """[(function, registers, spill store bytes, spill load bytes)] for
    each entry function in kernel ``name``'s ``-Xptxas -v`` log; names
    demangled with ``c++filt`` where it is on the PATH."""
    import re
    import shutil
    from repro_torch.kernels import _build
    log = _build.lib_path(name).with_suffix(".log").read_text()
    rows, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.append([fn, int(m.group(1)), *spill])
            fn = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if len(names) == len(rows):
            for r, nm in zip(rows, names):
                nm = nm.replace("(anonymous namespace)::", "")
                r[0] = nm.split("(")[0].replace("void ", "")
    return rows


def kernel_ms(fn, n=25):
    """{device kernel name: device ms per call of fn} over n calls under
    torch.profiler, after a warm-up; None when the capture lost records.

    Each call is followed by one ``torch.cuda._sleep`` (a spin_kernel of
    its own, left out of the result), so a capture that kept fewer than n
    of them lost records and reads "not measured". In long runs captures
    lose the records of some of their calls (7 or 14 of 25), whichever
    kernels they hold, and idling the card at either end of the capture
    does not prevent it; ``device_ms`` does not depend on the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.self_device_time_total > 0]
    marks = sum(e.count for e in rows if "spin_kernel" in e.key)
    if marks != n:
        say(f"    (the profiler kept {marks} of {n} markers: not measured)")
        return None
    return {e.key: e.self_device_time_total / 1e3 / n for e in rows
            if "spin_kernel" not in e.key}


BACKLOG_CYCLES = 50_000_000     # one spin kernel, ~25 ms at the H100's clock


def device_ms(fn, n=25):
    """Median device ms of one call of fn by CUDA events around each call,
    after a warm-up. The n calls are queued behind one long spin kernel,
    so they run back to back on the card and no host launch gap falls
    inside a call's events; if the host took longer to queue them than
    the spin lasted, that is said."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(BACKLOG_CYCLES)
    s1.record()
    t0 = time.perf_counter()
    evs = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if queued_ms >= s0.elapsed_time(s1):
        say(f"    (queueing took {queued_ms:.2f} ms, longer than the "
            f"{s0.elapsed_time(s1):.2f} ms spin: host gaps may be counted)")
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def host_ms(fn, n=50):
    """Mean host time of one call of fn, launches only (no sync inside
    the timed loop; the queue is drained before and after)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def phase_card():
    import torch
    say("== phase 1: card")
    smi = nvidia_smi_line()
    say(f"card: {smi}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("tf32: torch.backends.cuda.matmul.allow_tf32=False "
        "torch.backends.cudnn.allow_tf32=False")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    say("== phase 2: build")
    t0 = time.perf_counter()
    secs = _build.build_all()
    say(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f}s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in secs.items()})})")


def _randn(gen, shape, dtype, scale=1.0):
    import torch
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            ).to(dtype)


def _paged_case(B, K, G, r, nb, bs, maxb, *, seed=0, dtype=None,
                inactive_last=True):
    """tests/test_paged_attention.py::_case on the card: random q and
    pools, a ragged block table (per-row random ctx_len, just enough blocks
    assigned, the rest -1) and optionally one inactive slot (ctx 0, no
    blocks)."""
    import numpy as np
    import torch
    dtype = dtype or torch.float32
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn(gen, (B, K, G, r), dtype)
    kp = _randn(gen, (nb, bs, K, r), dtype)
    vp = _randn(gen, (nb, bs, K, r), dtype)
    ctx = np.array([rng.randint(0, maxb * bs) for _ in range(B)], np.int32)
    table = np.full((B, maxb), -1, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B):
        if inactive_last and b == B - 1:
            ctx[b] = 0
            continue
        for j in range(ctx[b] // bs + 1):
            table[b, j] = free.pop()
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.from_numpy(ctx).cuda())


def phase_kernels():
    """Each kernel against its plain version; returns the max abs error at
    the main path's shapes per kernel."""
    import torch
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.cur_matmul.ref import cur_matmul_ref
    from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    say("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {"cur_matmul": 0.0, "flash_attention": 0.0}
    failures = []

    def check(label, y, yr, dtype, main):
        tol = BF16_TOL if dtype == bf16 else F32_TOL
        rel = rel_err(y, yr)
        abs_err = float((y.float() - yr.float()).abs().max())
        ok = rel < tol and bool(torch.isfinite(y.float()).all())
        say(f"  {label}: rel {rel:.3e} (tol {tol:g}) abs {abs_err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return abs_err if main else 0.0

    cur_cases = [("", M) + CUR_SHAPES[k] + (dt, True)
                 for M in (CUR_M, VERIFY_M)
                 for k in CUR_SHAPES for dt in (bf16, f32)]
    # the ranks a plan assigns at full width (phase 10), bf16
    cur_cases += [("", M, m, r, n, bf16, True) for M in (CUR_M, VERIFY_M)
                  for (m, _, n) in CUR_SHAPES.values() for r in PLAN_RANKS]
    # the other families' classes at the row counts phase 11 gives them
    cur_cases += [(f"{name} ", M) + shape + (dt, True)
                  for name, (shape, Ms) in FAMILY_CUR.items() for M in Ms
                  for dt in (bf16, f32)]
    cur_cases += [("", 96, 100, 24, 200, f32, False),
                  ("", 96, 100, 24, 200, bf16, False),  # fused body (m 100)
                  ("", 512, 1024, 16, 1024, bf16, False),
                  ("", 512, 1024, 24, 1024, bf16, False),
                  ("", 1024, 2048, 512, 1024, bf16, False),
                  ("", 1024, 1000, 64, 520, bf16, False),  # split, slice edge
                  ("", 300, 512, 40, 264, bf16, False)]  # ragged M, last tile
    for name, M, m, r, n, dt, main in cur_cases:
        x = _randn(gen, (M, m), dt)
        cu = _randn(gen, (m, r), dt, m ** -0.5)
        rr = _randn(gen, (r, n), dt, r ** -0.5)
        y = cm.cur_matmul(x, cu, rr)
        torch.cuda.synchronize()
        body = cm.plan(M, m, r, n, dt).body
        label = f"cur_matmul {name}M={M} m={m} r={r} n={n}"
        e = check(f"{label} {dt} ({body})", y, cur_matmul_ref(x, cu, rr), dt,
                  main and dt == bf16)
        worst["cur_matmul"] = max(worst["cur_matmul"], e)
        if dt == bf16 and (main or m == 100):   # main: phase 6 to 11's rows
            # no atomics: a second call gives the same bits
            same = torch.equal(y, cm.cur_matmul(x, cu, rr))
            say(f"  {label} repeat {'bit-identical' if same else 'DIFFERS'}")
            if not same:
                failures.append(f"cur_matmul repeat {name}M={M} n={n}")
    x = _randn(gen, (2, 8, 16, 128), f32)
    cu = _randn(gen, (128, 32), f32)
    rr = _randn(gen, (32, 256), f32)
    y = cur_matmul_op(x, cu, rr)
    if tuple(y.shape) != (2, 8, 16, 256):
        failures.append(f"cur_matmul_op leading dims shape {tuple(y.shape)}")
    check("cur_matmul_op leading dims (2,8,16,128)", y,
          cur_matmul_ref(x.reshape(-1, 128), cu, rr).reshape(y.shape), f32,
          False)

    B, H, K, S, d = FLASH_SHAPE
    flash_cases = [  # B, H, K, S, d, window, causal, dtype, main
        (B, H, K, S, d, 0, True, bf16, True),
        (B, H, K, S, d, 0, True, f32, False),
        (2, H, K, S, d, 128, True, bf16, False),
        (1, 8, 2, 1024, 64, 0, True, bf16, False),
        (1, 4, 2, 128, 32, 48, True, f32, False),
        (1, 4, 2, 200, 64, 0, True, f32, False),      # ragged S
        (1, 4, 2, 200, 64, 0, False, f32, False),     # ragged, non-causal
        (1, 4, 2, 72, 16, 0, False, bf16, False),
        (2, 4, 4, 64, 16, 0, True, f32, False),       # MHA, d 16
        (1, 8, 1, 128, 32, 0, True, f32, False),      # MQA, d 32
    ]
    # head dim 256: gemma3-1b's local layers (window 512), windows 0 / 8
    # / 512, G 1 / 4, ragged S, non-causal
    gB, gH, gK, gS, gd, gw = FAMILY_FLASH["gemma3 d 256"]
    flash_cases += [
        (gB, gH, gK, gS, gd, gw, True, bf16, True),
        (gB, gH, gK, gS, gd, gw, True, f32, False),
        (1, 4, 4, 200, 256, 0, True, f32, False),
        (1, 4, 4, 200, 256, 8, True, bf16, False),
        (2, 4, 1, 130, 256, 8, True, f32, False),
        (2, 4, 1, 130, 256, 0, True, bf16, False),
        (1, 4, 1, 100, 256, 0, False, f32, False),
        (1, 4, 1, 100, 256, 0, False, bf16, False),
        (1, 4, 1, 600, 256, 512, True, bf16, False),
        (1, 4, 4, 600, 256, 512, True, f32, False)]
    for b, h, k, s, dd, win, causal, dt, main in flash_cases:
        q = _randn(gen, (b, h, s, dd), dt)
        kk = _randn(gen, (b, k, s, dd), dt)
        v = _randn(gen, (b, k, s, dd), dt)
        scale = dd ** -0.5
        o = fa.flash_attention(q, kk, v, causal=causal, window=win,
                               scale=scale)
        torch.cuda.synchronize()
        e = check(f"flash_attention B={b} H={h} K={k} S={s} d={dd} "
                  f"window={win} causal={causal} {dt} "
                  f"({fa.plan(b, h, s, dd, dt).body})", o,
                  flash_attention_ref(q, kk, v, causal=causal, window=win,
                                      scale=scale), dt, main)
        worst["flash_attention"] = max(worst["flash_attention"], e)
        if main:
            same = torch.equal(o, fa.flash_attention(
                q, kk, v, causal=causal, window=win, scale=scale))
            say(f"  flash_attention main shape d={dd} repeat "
                f"{'bit-identical' if same else 'DIFFERS'}")
            if not same:
                failures.append(f"flash_attention repeat d={dd}")
    try:
        fa.flash_attention(_randn(gen, (1, 6, 32, 16), f32),
                           _randn(gen, (1, 4, 32, 16), f32),
                           _randn(gen, (1, 4, 32, 16), f32))
        failures.append("flash_attention H % K raise")
    except ValueError as exc:
        say(f"  flash_attention H=6 K=4 raises: {exc}")

    # paged_attention: tests/test_paged_attention.py's grid, then the
    # serving path's full-width shapes
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    worst["paged_attention"] = 0.0

    def check_paged(label, args, dtype, main=False, window=0, span=1,
                    zero_last=False):
        y = pa.paged_attention(*args, window=window, q_span=span)
        torch.cuda.synchronize()
        yr = paged_attention_ref(*args, window=window, q_span=span)
        tol = BF16_TOL if dtype == bf16 else PAGED_F32_TOL
        rel = rel_err(y, yr)
        abs_err = float((y.float() - yr.float()).abs().max())
        ok = rel < tol and bool(torch.isfinite(y.float()).all())
        if zero_last:   # inactive slot: exact zeros on both paths
            ok = ok and not bool(y[-1].any()) and not bool(yr[-1].any())
        say(f"  {label}: rel {rel:.3e} (tol {tol:g}) abs {abs_err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        if main:
            worst["paged_attention"] = max(worst["paged_attention"], abs_err)
        return y

    for B, K, G, r, nb, bs, maxb, win in [
            (3, 2, 2, 16, 12, 4, 5, 0), (4, 4, 1, 8, 16, 8, 3, 0),
            (2, 1, 4, 32, 8, 16, 2, 0), (3, 2, 3, 16, 12, 4, 5, 7),
            (3, 2, 2, 16, 12, 4, 5, 3)]:
        check_paged(f"paged_attention B={B} K={K} G={G} r={r} bs={bs} "
                    f"maxb={maxb} window={win} f32",
                    _paged_case(B, K, G, r, nb, bs, maxb), f32, window=win,
                    zero_last=True)
    check_paged("paged_attention B=2 K=2 G=2 r=16 bs=4 maxb=4 bf16",
                _paged_case(2, 2, 2, 16, 8, 4, 4, dtype=bf16), bf16)
    for B, K, G, r, nb, bs, maxb, win, span in [
            (3, 2, 2, 16, 16, 4, 7, 0, 4), (2, 1, 4, 8, 12, 8, 4, 0, 2),
            (3, 2, 3, 16, 16, 4, 7, 5, 3)]:
        q, kp, vp, table, ctx = _paged_case(B, K, span * G, r, nb, bs, maxb,
                                            inactive_last=False)
        ctx = torch.clamp(torch.minimum(
            ctx, (table >= 0).sum(1).int() * bs - span), min=0)
        check_paged(f"paged_attention q_span={span} B={B} K={K} G={G} "
                    f"r={r} window={win} f32", (q, kp, vp, table, ctx), f32,
                    window=win, span=span)
    # split-KV: tables the plan splits, with splits that hold no live
    # entry (ragged contexts, the inactive slot), windows that start
    # inside a split, rows past one m16 tile, r 8 .. 256, bs 4 .. 32
    for B, K, G, r, bs, maxb, win in [
            (3, 2, 4, 16, 4, 80, 0), (3, 2, 4, 8, 8, 40, 0),
            (3, 2, 4, 12, 8, 40, 0), (4, 2, 4, 64, 16, 69, 0),
            (4, 2, 4, 128, 16, 69, 100), (2, 2, 8, 256, 32, 40, 0),
            (2, 1, 20, 128, 16, 69, 37)]:
        for dt in (bf16, f32):
            p = pa.plan(B, K, G, r, bs, maxb, dt,
                        sms=pa._sm_count(torch.cuda.current_device()))
            check_paged(f"paged_attention B={B} K={K} G={G} r={r} bs={bs} "
                        f"maxb={maxb} window={win} {dt} ({p.body}, "
                        f"{p.splits} splits of {p.entries_per_split})",
                        _paged_case(B, K, G, r, B * maxb, bs, maxb,
                                    dtype=dt), dt, window=win,
                        zero_last=True)
    for span, win in [(2, 0), (3, 21), (4, 0)]:
        q, kp, vp, table, ctx = _paged_case(3, 2, 4 * span, 64, 120, 8, 40,
                                            inactive_last=False)
        ctx = torch.clamp(torch.minimum(
            ctx, (table >= 0).sum(1).int() * 8 - span), min=0)
        check_paged(f"paged_attention q_span={span} B=3 K=2 G={4 * span} "
                    f"r=64 bs=8 maxb=40 window={win} f32 (split)",
                    (q, kp, vp, table, ctx), f32, window=win, span=span)
        check_paged(f"paged_attention q_span={span} B=3 K=2 G={4 * span} "
                    f"r=64 bs=8 maxb=40 window={win} bf16 (split)",
                    tuple(t.to(bf16) if t.is_floating_point() else t
                          for t in (q, kp, vp, table, ctx)), bf16,
                    window=win, span=span)
    Bp, Kp, Gp, bsp, maxbp = PAGED_SHAPE
    for r in (128, KV_RANK):
        for dt in (bf16, f32):
            args = _paged_case(Bp, Kp, Gp, r, Bp * maxbp, bsp, maxbp,
                               dtype=dt)
            check_paged(f"paged_attention B={Bp} K={Kp} G={Gp} r={r} "
                        f"bs={bsp} maxb={maxbp} {dt}", args, dt,
                        main=dt == bf16, zero_last=True)
            if dt == bf16:
                # the splits merge in a fixed order: the same bits again
                y = pa.paged_attention(*args)
                same = all(torch.equal(y, pa.paged_attention(*args))
                           for _ in range(3))
                say(f"  paged_attention r={r} serving shape repeat "
                    f"{'bit-identical' if same else 'DIFFERS'}")
                if not same:
                    failures.append(f"paged_attention repeat r={r}")
    # the speculative verify layout at full width: span = k + 1 query
    # positions per slot, row s G + g at position ctx + s (G' = 20 at
    # spec_k 4: two m16 tiles), split tables with ragged contexts
    for span in VERIFY_SPANS:
        for r in (128, KV_RANK):
            for dt in (bf16, f32):
                args = _paged_inputs(gen, r, RAGGED_CTX, span=span, dtype=dt)
                p = pa.plan(Bp, Kp, span * Gp, r, bsp, maxbp, dt,
                            sms=pa._sm_count(torch.cuda.current_device()))
                label = (f"paged_attention verify q_span={span} B={Bp} "
                         f"K={Kp} G'={span * Gp} r={r} bs={bsp} "
                         f"maxb={maxbp} ctx={min(RAGGED_CTX)}-"
                         f"{max(RAGGED_CTX)} {dt} ({p.body}, {p.splits} "
                         f"splits of {p.entries_per_split})")
                y = check_paged(label, args, dt, main=dt == bf16, span=span)
                same = all(torch.equal(y, pa.paged_attention(*args,
                                                             q_span=span))
                           for _ in range(2))
                say(f"  {label} repeat "
                    f"{'bit-identical' if same else 'DIFFERS'}")
                if not same:
                    failures.append(f"paged_attention verify repeat "
                                    f"span={span} r={r} {dt}")
    z = torch.zeros
    for label, args, span in [
            ("pool/query mismatch", (z((2, 2, 2, 8), device="cuda"),
                                     z((4, 4, 2, 8), device="cuda"),
                                     z((4, 4, 2, 4), device="cuda"),
                                     z((2, 2), dtype=torch.int32,
                                       device="cuda"),
                                     z((2,), dtype=torch.int32,
                                       device="cuda")), 1),
            ("q_span 4 with 6 rows", _paged_case(2, 2, 6, 8, 8, 4, 4), 4)]:
        try:
            pa.paged_attention(*args, q_span=span)
            failures.append(f"paged_attention raise: {label}")
        except ValueError as exc:
            say(f"  paged_attention {label} raises: {exc}")

    # the paged family cases: gemma3's r 256 and mixtral's window 4096, q
    # carrying the softmax scale r^-0.5 as runtime.fold_q gives it on a
    # dense pool (r = hd); then the same f32 inputs without the scale
    # (scores of std r^0.5), the kernel against an f64 result at the f32
    # bound, and the plain f32 version's reading beside it
    for name, (B, K, G, r, bs, ctxs, win) in FAMILY_PAGED.items():
        shape = (B, K, G, bs, -(-(max(ctxs) + 1) // bs))
        for dt in (bf16, f32):
            args = _paged_inputs(gen, r, ctxs, dtype=dt, shape=shape,
                                 q_scale=r ** -0.5)
            check_paged(f"paged_attention {name} B={B} K={K} G={G} r={r} "
                        f"bs={bs} ctx={min(ctxs)}-{max(ctxs)} window={win} "
                        f"{dt}", args, dt, window=win)
        q, kp, vp, table, ctx = args
        q = q * r ** 0.5
        y = pa.paged_attention(q, kp, vp, table, ctx, window=win)
        y64 = _paged_f64(q, kp, vp, table, ctx, win)
        rel = rel_err(y.double(), y64)
        rel32 = rel_err(paged_attention_ref(q, kp, vp, table, ctx,
                                            window=win).double(), y64)
        ok = rel < PAGED_F32_TOL
        say(f"  paged_attention {name} f32, q without the scale: kernel vs "
            f"f64 rel {rel:.3e} (tol {PAGED_F32_TOL:g}) "
            f"{'ok' if ok else 'FAIL'}; plain f32 vs f64 rel {rel32:.3e}")
        if not ok:
            failures.append(f"paged_attention {name} unscaled vs f64")

    # the registry's flash adaptor zero-pads a feature dim between the
    # kernel's widths (rank-space CUR-KV prefill at r = 8, 24, 48: folded
    # queries carry the scale, the kernel gets 1.0; d 160 pads to 256),
    # against the kernel's plain version at the unpadded width
    from repro_torch.attention import registry
    for d, dt, win in [(8, f32, 0), (24, f32, 0), (48, f32, 0), (8, bf16, 0),
                       (24, bf16, 0), (48, bf16, 0), (160, f32, 8),
                       (160, bf16, 8)]:
        B, S, K, G = 2, 96, 2, 2
        qg = _randn(gen, (B, S, K, G, d), dt, d ** -0.5)
        kk = _randn(gen, (B, S, K, d), dt)
        v = _randn(gen, (B, S, K, d), dt)
        pos = torch.arange(S, device="cuda")[None].expand(B, S)
        f0 = fa.launches
        o = registry._mix_flash_cuda(qg, kk, v, pos, pos, win, 1.0, chunk=0)
        torch.cuda.synchronize()
        ref = flash_attention_ref(
            qg.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, d),
            kk.transpose(1, 2), v.transpose(1, 2), window=win, scale=1.0)
        ref = ref.reshape(B, K, G, S, d).permute(0, 3, 1, 2, 4)
        check(f"flash_attention padded d={d} -> "
              f"{registry._padded_dim(d)} window={win} {dt}", o, ref, dt,
              False)
        if fa.launches != f0 + 1:
            failures.append(f"flash padded d={d}: kernel not launched")
    flash_grads(gen, check, failures)
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")
    return worst


def _paged_f64(q, kp, vp, table, ctx, window):
    """paged_attention in float64, slot by slot: keys at positions t <= ctx
    and, with a window, t > ctx - window."""
    import torch
    out = torch.zeros(q.shape, dtype=torch.float64, device=q.device)
    bs = kp.shape[1]
    for b in range(q.shape[0]):
        c = int(ctx[b])
        blocks = table[b, :c // bs + 1].long()
        k = kp[blocks].reshape(-1, *kp.shape[2:])[:c + 1].double()
        v = vp[blocks].reshape(-1, *vp.shape[2:])[:c + 1].double()
        t = torch.arange(c + 1, device=q.device)
        live = t > c - window if window > 0 else t >= 0
        s = torch.einsum("kgr,tkr->kgt", q[b].double(), k)
        s = s.masked_fill(~live, float("-inf"))
        out[b] = torch.einsum("kgt,tkr->kgr", torch.softmax(s, -1), v)
    return out


def flash_grads(gen, check, failures):
    """Phase 3's gradient checks of FlashAttentionFn (the kernel's forward,
    the plain backward ``flash_attention_bwd``): dq / dk / dv against
    autograd through the plain forward over the kernel's grid (d 16 / 32
    / 64 / 128, G 1 / 2 / 4, window 0 / 8, ragged S, f32 and bf16); the
    forward-only ops raising under grad; then the backward's time at the
    olmo-1b train and llama3.1-8b heal shapes beside SDPA's backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.backward import (
        flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_attention_op
    f32, bf16 = torch.float32, torch.bfloat16
    n, bad = 0, []
    for i, (d, G, win, dt) in enumerate(
            (d, G, win, dt) for d in (16, 32, 64, 128) for G in (1, 2, 4)
            for win in (0, 8) for dt in (f32, bf16)):
        S = (40, 72, 100, 130)[i % 4]               # ragged: no 64 multiple
        B, K = 1 + i % 2, 2
        q, k, v, do = (_randn(gen, (B, h, S, d), dt) for h in
                       (K * G, K, K, K * G))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        f0 = fa.launches
        o = flash_attention_op(*leaves, window=win, scale=d ** -0.5)
        got = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = torch.autograd.grad(flash_attention_ref(
            *ref_leaves, window=win, scale=d ** -0.5), ref_leaves, do)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        rels = [rel_err(a, b) for a, b in zip(got, ref)]
        ok = (max(rels) < tol and fa.launches == f0 + 1
              and all(a.dtype == dt for a in got))
        n += 1
        if not ok:
            bad.append(f"flash grads d={d} G={G} window={win} {dt}")
            say(f"  flash grads B={B} K={K} G={G} S={S} d={d} window={win} "
                f"{dt}: rel dq/dk/dv {', '.join(f'{r:.3e}' for r in rels)}"
                f" (tol {tol:g}) FAIL")
    say(f"  FlashAttentionFn gradients, {n} cases (d 16/32/64/128, G "
        f"1/2/4, window 0/8, S 40/72/100/130, f32 and bf16): dq, dk, dv "
        f"against autograd through the plain forward "
        f"{'all within' if not bad else 'NOT all within'} "
        f"{F32_TOL:g} (f32) / {BF16_TOL:g} (bf16)")
    failures.extend(bad)
    x, cu, rr = (_randn(gen, s, bf16) for s in ((64, 128), (128, 16),
                                                 (16, 128)))
    paged = _paged_case(2, 2, 2, 16, 8, 4, 4)
    for label, op, args in (("cur_matmul_op", cur_matmul_op, (x, cu, rr)),
                            ("paged_attention_op", paged_attention_op,
                             paged)):
        args[0].requires_grad_(True)
        try:
            op(*args)
            failures.append(f"{label} under grad did not raise")
        except RuntimeError as exc:
            say(f"  {label} with an input that requires grad raises: {exc}")
    # the backward's time at the training shapes, beside SDPA's backward
    for label, (B, H, K, S, d) in (("olmo-1b train", (8, 16, 16, 128, 128)),
                                   ("llama3.1-8b heal", (2, 32, 8, 512,
                                                          128))):
        q, o, do = (_randn(gen, (B, H, S, d), bf16) for _ in range(3))
        k, v = (_randn(gen, (B, K, S, d), bf16) for _ in range(2))
        scale = d ** -0.5
        o = fa.flash_attention(q, k, v, scale=scale)
        ms = median_ms(lambda: flash_attention_bwd(
            q, k, v, o, do, causal=True, window=0, scale=scale))
        ls = [t.clone().requires_grad_(True) for t in (q, k, v)]
        so = F.scaled_dot_product_attention(*ls, is_causal=True, scale=scale,
                                            enable_gqa=True)
        lib = median_ms(lambda: torch.autograd.grad(so, ls, do,
                                                    retain_graph=True))
        pairs = S * (S + 1) // 2
        nbytes = 2 * (4 * B * H * S * d + 4 * B * K * S * d)
        flops = 10 * B * H * d * pairs      # S, dV, dP, dQ, dK over live pairs
        bnd, by = bound_ms(nbytes, flops)
        say(f"  flash_attention backward, {label} shape B={B} H={H} K={K} "
            f"S={S} d={d} bf16: plain backward {ms:.4f} ms, SDPA backward "
            f"{lib:.4f} ms, bound {bnd:.4f} ms ({by})")


def _paged_inputs(gen, r, ctxs=None, span=1, dtype=None, shape=PAGED_SHAPE,
                  q_scale=1.0):
    """Inputs of paged_attention at ``shape`` (B, K, G, bs, maxb; the
    serving shape by default), bf16 unless ``dtype``: q times ``q_scale``,
    a random pool of B maxb blocks, each slot's table a random permutation
    of its blocks; ctx maxb bs - 1 for every slot, or ``ctxs`` (then the
    entries past a slot's last position are unassigned, as the scheduler
    leaves them). ``span`` > 1 gives the verify layout: span G query rows
    per (slot, kv head), the last at ctx + span - 1."""
    import torch
    B, K, G, bs, maxb = shape
    dtype = dtype or torch.bfloat16
    q = _randn(gen, (B, K, span * G, r), dtype, q_scale)
    kp = _randn(gen, (B * maxb, bs, K, r), dtype)
    vp = _randn(gen, (B * maxb, bs, K, r), dtype)
    table = torch.randperm(B * maxb, device="cuda").reshape(B, maxb).int()
    if ctxs is None:
        ctx = torch.full((B,), maxb * bs - 1, dtype=torch.int32,
                         device="cuda")
    else:
        ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
        j = torch.arange(maxb, device="cuda")[None]
        table = torch.where(j <= (ctx[:, None] + span - 1) // bs, table,
                            -1).int()
    return q, kp, vp, table, ctx


def _sdpa_on_gathered(q, kp, vp, table, ctx, span=1, window=0):
    """The library yardstick of paged_attention, gather excluded: SDPA
    over the pool gathered once into a contiguous (B, K, L, r) view with a
    boolean mask (row g of the verify layout at position ctx + g // G;
    with a window, only its last ``window`` positions). Returns the call
    to time."""
    import torch
    import torch.nn.functional as F
    B, maxb = table.shape
    _, bs, K, r = kp.shape
    L = maxb * bs
    tb = table.long().clamp(min=0)
    kc = kp[tb].reshape(B, L, K, r).transpose(1, 2).contiguous()
    vc = vp[tb].reshape(B, L, K, r).transpose(1, 2).contiguous()
    rows = q.shape[2]
    last = ctx[:, None].long() + torch.arange(
        rows, device="cuda")[None] // (rows // span)          # (B, rows)
    t = torch.arange(L, device="cuda")[None, None]
    mask = t <= last[..., None]                               # (B,rows,L)
    if window:
        mask &= t > last[..., None] - window
    mask = mask[:, None]                                      # (B,1,rows,L)
    return lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                                  scale=1.0)


def phase_times():
    """Per-kernel times at the main path's shapes (bf16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.cur_matmul.ref import cur_matmul_ref
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    say("== phase 4: times (median of 25 launches, CUDA events, bf16)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    rows = {}
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes": 0, "flops": 0}
    # the llama classes at calibration's rows (the kernel table's row),
    # then the other families' classes there and at their largest rows
    cur_rows = [("", CUR_M, shape) for shape in CUR_SHAPES.values()]
    cur_rows += [(f"{name} ", M, shape)
                 for name, (shape, Ms) in FAMILY_CUR.items()
                 for M in sorted({CUR_M, max(Ms)})]
    for name, M, (m, r, n) in cur_rows:
        x = _randn(gen, (M, m), bf16)
        cu = _randn(gen, (m, r), bf16, m ** -0.5)
        rr = _randn(gen, (r, n), bf16, r ** -0.5)
        fn = lambda: cm.cur_matmul(x, cu, rr)
        chain = lambda: torch.matmul(torch.matmul(x, cu), rr)
        ms, lib = median_ms(fn), median_ms(chain)
        plain = median_ms(lambda: cur_matmul_ref(x, cu, rr))
        nbytes = 2 * (M * m + m * r + r * n + M * n)
        flops = 2 * M * r * (m + n)
        bnd, by = bound_ms(nbytes, flops)
        say(f"  cur_matmul {name}M={M} m={m} r={r} n={n} "
            f"({cm.plan(M, m, r, n, bf16).body}): kernel {ms:.4f} ms "
            f"(device {device_ms(fn):.4f}), plain {plain:.4f} ms, library "
            f"{lib:.4f} ms (device {device_ms(chain):.4f}), bound "
            f"{bnd:.4f} ms ({by}); {nbytes / ms / 1e6:.1f} GB/s, "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        say(f"    host {host_ms(fn):.4f} ms per call (launches only)")
        if not name:
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bnd), ("bytes", nbytes),
                         ("flops", flops)):
                tot[k] += v
    _, by = bound_ms(tot["bytes"], tot["flops"])
    rows["cur_matmul"] = dict(tot, bound_by=by)
    say(f"  cur_matmul wq + wk + w_gate: kernel {tot['ms']:.4f} ms, "
        f"library {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} "
        f"ms; {tot['bytes'] / tot['ms'] / 1e6:.1f} GB/s, "
        f"{tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s")

    # flash_attention at llama's prefill (the kernel table's row), then at
    # gemma3's head dim 256 and mixtral's window 4096, beside SDPA with
    # the same mask
    flash_rows = [("", FLASH_SHAPE + (0,))]
    flash_rows += [(f"{name} ", shape) for name, shape in FAMILY_FLASH.items()]
    for name, (B, H, K, S, d, win) in flash_rows:
        q = _randn(gen, (B, H, S, d), bf16)
        k = _randn(gen, (B, K, S, d), bf16)
        v = _randn(gen, (B, K, S, d), bf16)
        scale = d ** -0.5
        fn = lambda: fa.flash_attention(q, k, v, window=win, scale=scale)
        sdpa = _sdpa_window(q, k, v, win, scale) if win else (
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale, enable_gqa=True))
        ms, lib = median_ms(fn), median_ms(sdpa)
        plain = median_ms(lambda: flash_attention_ref(q, k, v, window=win,
                                                      scale=scale))
        nbytes = 2 * (2 * B * H * S * d + 2 * B * K * S * d)
        flops = 4 * B * H * d * _live_pairs(S, win)     # live causal pairs
        bnd, by = bound_ms(nbytes, flops)
        say(f"  flash_attention {name}B={B} H={H} K={K} S={S} d={d} "
            f"window={win} causal ({fa.plan(B, H, S, d, bf16).body}): kernel "
            f"{ms:.4f} ms (device {device_ms(fn):.4f}), plain {plain:.4f} "
            f"ms, library {lib:.4f} ms (device {device_ms(sdpa):.4f}), "
            f"bound {bnd:.4f} ms ({by}); {nbytes / ms / 1e6:.1f} GB/s, "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        say(f"    host {host_ms(fn):.4f} ms per call (launches only)")
        if not name:
            rows["flash_attention"] = {"ms": ms, "plain_ms": plain,
                                       "library_ms": lib, "bound_ms": bnd,
                                       "bound_by": by}
        del q, k, v

    # paged_attention at the serving path's full-width decode step: every
    # slot at the longest context phase 7 reaches (all maxb blocks live),
    # then at workload B's spread of contexts (ragged: the splits of the
    # shorter slots hold no live entry); then gemma3's r 256 and mixtral's
    # window 4096 (q carrying the scale, as on a dense pool)
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    paged_rows = [("", r, ctxs, PAGED_SHAPE, 1.0, 0)
                  for ctxs in (None, RAGGED_CTX) for r in (128, KV_RANK)]
    paged_rows += [(f"{name} ", r, ctxs,
                    (B, K, G, bs, -(-(max(ctxs) + 1) // bs)), r ** -0.5, win)
                   for name, (B, K, G, r, bs, ctxs, win)
                   in FAMILY_PAGED.items()]
    for name, r, ctxs, shape, q_scale, win in paged_rows:
        B, K, G, bs, maxb = shape
        q, kp, vp, table, ctx = _paged_inputs(gen, r, ctxs, shape=shape,
                                              q_scale=q_scale)
        fn = lambda: pa.paged_attention(q, kp, vp, table, ctx, window=win)
        sdpa = _sdpa_on_gathered(q, kp, vp, table, ctx, window=win)
        ms, lib = median_ms(fn), median_ms(sdpa)
        plain = median_ms(lambda: paged_attention_ref(q, kp, vp, table, ctx,
                                                      window=win))
        # live (slot, head, t): the in-window positions of each slot
        live = sum(min(c + 1, win) if win else c + 1
                   for c in ctx.tolist()) * K
        nbytes = 2 * (2 * live * r + 2 * B * K * G * r)
        flops = 4 * live * G * r
        bnd, by = bound_ms(nbytes, flops)
        p = pa.plan(B, K, G, r, bs, maxb, bf16,
                    sms=pa._sm_count(torch.cuda.current_device()))
        span = (f"ctx={maxb * bs - 1}" if ctxs is None else
                f"ctx={min(ctxs)}-{max(ctxs)} (ragged)")
        say(f"  paged_attention {name}B={B} K={K} G={G} r={r} bs={bs} "
            f"maxb={maxb} {span} window={win} ({p.body}, {p.splits} splits "
            f"of {p.entries_per_split} entries, {p.grid[0] * p.grid[1]} "
            f"blocks): kernel {ms:.4f} ms (device {device_ms(fn):.4f}), "
            f"plain {plain:.4f} ms, library (SDPA, gather excluded) "
            f"{lib:.4f} ms (device {device_ms(sdpa):.4f}), bound {bnd:.4f} "
            f"ms ({by}); {nbytes / ms / 1e6:.1f} GB/s")
        say(f"    host {host_ms(fn):.4f} ms per call (launches only)")
        if (name, r, ctxs) == ("", 128, None):
            rows["paged_attention"] = {"ms": ms, "plain_ms": plain,
                                       "library_ms": lib, "bound_ms": bnd,
                                       "bound_by": by}
    times_verify(gen)
    times_plan_ranks(gen)
    from repro_torch.kernels import _build
    for name in _build.KERNELS:
        for fn, regs, st, ld in ptxas_report(name):
            say(f"  ptxas {name}: {fn}: {regs} registers, spill stores "
                f"{st} B, spill loads {ld} B")
    return rows


def _live_pairs(S, window):
    """Causal (query, key) pairs inside the window over S positions."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(S))


def _sdpa_window(q, k, v, window, scale):
    """SDPA with the causal sliding-window mask (one library call)."""
    import torch
    import torch.nn.functional as F
    S = q.shape[2]
    i = torch.arange(S, device="cuda")
    mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def times_verify(gen):
    """Phase 4's lines of the speculative verify shapes: paged_attention
    at q_span k + 1 (G' = 20) on workload B's ragged contexts, r 128 and
    64, against its bound and SDPA on a pre-gathered pool; cur_matmul at
    M 40 for wq / wk / w_gate against the torch.matmul chain."""
    import torch
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.cur_matmul.ref import cur_matmul_ref
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B, K, G, bs, maxb = PAGED_SHAPE
    span = SPEC_K + 1
    for r in (128, KV_RANK):
        q, kp, vp, table, ctx = _paged_inputs(gen, r, RAGGED_CTX, span=span)
        ms = median_ms(lambda: pa.paged_attention(q, kp, vp, table, ctx,
                                                  q_span=span))
        plain = median_ms(lambda: paged_attention_ref(q, kp, vp, table, ctx,
                                                      q_span=span))
        lib = median_ms(_sdpa_on_gathered(q, kp, vp, table, ctx, span))
        live = (sum(RAGGED_CTX) + B * span) * K     # (slot, head, t) read
        nbytes = 2 * (2 * live * r + 2 * B * K * span * G * r)
        # row s of a slot attends ctx + s + 1 positions
        flops = 4 * r * K * G * sum(c + s + 1 for c in RAGGED_CTX
                                    for s in range(span))
        bnd, by = bound_ms(nbytes, flops)
        p = pa.plan(B, K, span * G, r, bs, maxb, torch.bfloat16,
                    sms=pa._sm_count(torch.cuda.current_device()))
        say(f"  paged_attention verify q_span={span} B={B} K={K} "
            f"G'={span * G} r={r} bs={bs} maxb={maxb} ctx="
            f"{min(RAGGED_CTX)}-{max(RAGGED_CTX)} ({p.body}, {p.splits} "
            f"splits of {p.entries_per_split} entries): kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, library (SDPA, gather excluded) "
            f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}); "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        say(f"    host {host_ms(lambda: pa.paged_attention(q, kp, vp, table, ctx, q_span=span)):.4f}"
            f" ms per call (launches only)")
    tot = {"ms": 0.0, "lib": 0.0, "bound": 0.0}
    for name, (m, r, n) in CUR_SHAPES.items():
        M = VERIFY_M
        x = _randn(gen, (M, m), torch.bfloat16)
        cu = _randn(gen, (m, r), torch.bfloat16, m ** -0.5)
        rr = _randn(gen, (r, n), torch.bfloat16, r ** -0.5)
        ms = median_ms(lambda: cm.cur_matmul(x, cu, rr))
        plain = median_ms(lambda: cur_matmul_ref(x, cu, rr))
        lib = median_ms(lambda: torch.matmul(torch.matmul(x, cu), rr))
        nbytes = 2 * (M * m + m * r + r * n + M * n)
        bnd, by = bound_ms(nbytes, 2 * M * r * (m + n))
        say(f"  cur_matmul verify {name} M={M} m={m} r={r} n={n} "
            f"({cm.plan(M, m, r, n, torch.bfloat16).body}): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}); {nbytes / ms / 1e6:.1f} GB/s")
        tot["ms"] += ms
        tot["lib"] += lib
        tot["bound"] += bnd
    say(f"  cur_matmul verify wq + wk + w_gate M={VERIFY_M}: kernel "
        f"{tot['ms']:.4f} ms, library {tot['lib']:.4f} ms, bound "
        f"{tot['bound']:.4f} ms")


def times_plan_ranks(gen):
    """Phase 4's lines of the ranks a plan assigns (phase 10): cur_matmul
    at r 16 .. 512 on the full-width classes at M 2048 and M 40, kernel
    and host time beside the bound and the torch.matmul chain."""
    import torch
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    bf16 = torch.bfloat16
    for M in (CUR_M, VERIFY_M):
        for name, (m, _, n) in CUR_SHAPES.items():
            for r in PLAN_RANKS:
                x = _randn(gen, (M, m), bf16)
                cu = _randn(gen, (m, r), bf16, m ** -0.5)
                rr = _randn(gen, (r, n), bf16, r ** -0.5)
                ms = median_ms(lambda: cm.cur_matmul(x, cu, rr))
                lib = median_ms(lambda: torch.matmul(torch.matmul(x, cu),
                                                     rr))
                host = host_ms(lambda: cm.cur_matmul(x, cu, rr))
                nbytes = 2 * (M * m + m * r + r * n + M * n)
                bnd, by = bound_ms(nbytes, 2 * M * r * (m + n))
                say(f"  cur_matmul plan rank {name} M={M} m={m} r={r} n={n}"
                    f" ({cm.plan(M, m, r, n, bf16).body}): kernel "
                    f"{ms:.4f} ms, host {host:.4f} ms, bound {bnd:.4f} ms "
                    f"({by}), chain {lib:.4f} ms")


def _passes(parts):
    """cur_matmul's kernel_ms result by pass with their sum, or why there
    is none."""
    if parts is None:
        return "not measured (the profiler lost records)"
    if not parts:
        return "not measured (the profiler saw no kernel)"
    return ", ".join(f"{_pass_name(k)} {v:.4f} ms" for k, v in parts.items()
                     ) + f" (sum {sum(parts.values()):.4f} ms)"


def _pass_name(kernel):
    """cur_matmul's device kernels by their part of the function."""
    for key, label in (("pass1_kernel", "pass 1 (x @ CU, split-K)"),
                       ("reduce_kernel", "reduce (sum splits, round t)"),
                       ("pass2_kernel", "pass 2 (t @ R)"),
                       ("cur_matmul_kernel", "fused")):
        if key in kernel:
            return label
    return kernel[:60]


def phase_small():
    """The folded forward on the card (both kernels) against the same
    params on the CPU (plain versions), f32, at a small size."""
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_repro
    from repro_torch.configs.base import CURConfig
    from repro_torch.core import calibrate, compress_model
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import forward, init_params
    say("== phase 5: small f32 model on the card vs the CPU")
    cfg = get_repro()                         # llama-repro-8m, f32
    params = init_params(0, cfg, "cuda")
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 256, 4, seed=0), "cuda")
    calib = calibrate(params, cfg, [ds.batch_at(0)])
    ccfg = CURConfig(r_max=64, n_compress_layers=4, svd="exact",
                     fold_u=True)
    cparams, ccfg_model, info = compress_model(params, cfg, ccfg, calib)
    batch = ds.batch_at(1)
    c0, f0 = cm.launches, fa.launches
    y = forward(cparams, ccfg_model, batch)
    torch.cuda.synchronize()
    dcur, dflash = cm.launches - c0, fa.launches - f0
    y_cpu = forward(tree_map(lambda t: t.cpu(), cparams), ccfg_model,
                    tree_map(lambda t: t.cpu(), batch))
    rel = rel_err(y.cpu(), y_cpu)
    say(f"  {cfg.name}: layers {info.layers}, folded logits "
        f"{tuple(y.shape)}, card vs CPU rel {rel:.3e} (tol {F32_TOL:g}); "
        f"launches cur_matmul {dcur} flash_attention {dflash}")
    if not (rel < F32_TOL and dcur > 0 and dflash > 0):
        raise SystemExit("small-model check failed")

    # the same model served on the card and on the CPU: greedy tokens
    import numpy as np
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.launch.serve import make_workload
    from repro_torch.serving import PagedConfig, Server
    wl = make_workload(8, cfg.vocab_size, max_new=12)
    calib_toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 64))
    cpu_params = tree_map(lambda t: t.cpu(), cparams)
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    served = {}
    for cur_kv in (False, True):
        pc = PagedConfig.sized_for(max_len, 4, block_size=16, cur_kv=cur_kv,
                                   kv_rank=cfg.resolved_head_dim // 2)
        outs = served[cur_kv] = {}
        for dev, prm in (("cuda", cparams), ("cpu", cpu_params)):
            srv = Server(prm, ccfg_model, pc, max_concurrency=4,
                         calib_tokens=calib_toks, device=dev)
            p0 = pa.launches
            for w in wl:
                srv.submit(w["prompt"], w["max_new_tokens"])
            srv.drain()
            outs[dev] = {k: r.out_tokens for k, r in srv.finished.items()}
            if dev == "cuda":
                dpaged = pa.launches - p0
                steps = srv.stats()["n_decode_steps"]
        same = outs["cuda"] == outs["cpu"]
        say(f"  served {len(wl)} requests, {'CUR-KV r=' + str(pc.rank(cfg.resolved_head_dim)) if cur_kv else 'dense'} "
            f"pool: card and CPU greedy tokens "
            f"{'identical' if same else 'DIFFER'}; paged_attention "
            f"launches {dpaged} = {steps} decode steps x {cfg.n_layers}")
        if not (same and dpaged == steps * cfg.n_layers):
            raise SystemExit("small-model serving check failed")
    small_spec(params, cfg, wl, calib_toks)
    small_chaos(cparams, ccfg_model, wl, calib_toks, served[False]["cuda"])
    small_engine(cparams, ccfg_model, ds, wl, calib_toks,
                 served[False]["cuda"])
    small_train()


def small_train():
    """Phase 5's training checks, f32, card against CPU: one SMOKE train
    step's loss and gradients and one heal step's KD loss and dU gradients
    (2e-5; the card's forwards run flash_attention under autograd); then a
    REPRO ``train()`` with a checkpoint every 3 steps, resumed from step 3
    into a fresh run: its losses equal the uninterrupted run's (2e-5 on the
    card, bitwise on the CPU)."""
    import shutil
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_repro, get_smoke
    from repro_torch.configs.base import CURConfig, OptimizerConfig
    from repro_torch.core import calibrate, compress_model, heal
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.dist import CheckpointManager, tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import forward_hidden, init_params, loss_fn
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import train
    bad = []
    cfg = get_smoke("llama3.1-8b")
    params = init_params(0, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 129),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    sp, scfg, _ = compress_model(params, cfg, CURConfig(
        r_max=8, n_compress_layers=2), calibrate(params, cfg, [batch]))
    res, launched = {}, {}
    for dev in ("cuda", "cpu"):
        p, s, b = (tree_map(lambda t: t.to(dev), x)
                   for x in (params, sp, batch))
        f0 = fa.launches
        train_lg = heal.value_and_grad(lambda q: loss_fn(q, cfg, b), p)
        tr, fr = heal.partition_params(s, heal.trainable_mask(s, "dU"))
        with torch.no_grad():
            t_log, t_hid = forward_hidden(p, cfg, b)
        heal_lg = heal.value_and_grad(lambda t: heal.kd_loss_fn(
            heal.combine_params(t, fr), scfg, b, t_log, t_hid), tr)
        launched[dev] = fa.launches - f0
        res[dev] = (train_lg, heal_lg)
    for i, what in enumerate(("train step (all leaves)",
                              "heal step (dU leaves)")):
        (lg, gg), (lc, gc) = res["cuda"][i], res["cpu"][i]
        gl, cl = tree_flatten(gg), tree_flatten(gc)
        rels = [rel_err(a.cpu(), b) for a, b in zip(gl, cl)]
        rel_l = rel_err(lg.cpu(), lc)
        say(f"  SMOKE {what}: card vs CPU loss rel {rel_l:.3e}, "
            f"{len(rels)} gradients rel max {max(rels):.3e} "
            f"(tol {F32_TOL:g})")
        if not (rel_l < F32_TOL and max(rels) < F32_TOL
                and len(gl) == len(cl) > 0):
            bad.append(what)
    say(f"  flash_attention launches on the card: {launched['cuda']} "
        f"(3 forwards x {cfg.n_layers} layers)")
    if launched["cuda"] != 3 * cfg.n_layers:
        bad.append("flash_attention launches under autograd")

    rcfg = get_repro()
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        # multi-threaded CPU training is not bitwise repeatable (two
        # identical runs in one process differ in the last bits); one
        # thread is
        torch.set_num_threads(1 if dev == "cpu" else threads)
        ds = SyntheticLM(DataConfig(rcfg.vocab_size, 128, 4, seed=3), dev)
        batches = [ds.batch_at(i) for i in range(6)]
        p0 = init_params(0, rcfg, dev)
        d = os.path.join(ROOT, "build", "chip_smoke_train_ckpt", dev)
        shutil.rmtree(d, ignore_errors=True)
        mgr = CheckpointManager(d)
        _, _, full = train(p0, rcfg, ocfg, batches, ckpt_manager=mgr,
                           ckpt_every=3)
        step, state = mgr.restore(
            {"params": p0, "opt_state": AdamW(ocfg).init(p0)}, device=dev,
            step=3)
        _, _, resumed = train(state["params"], rcfg, ocfg, batches[3:],
                              start_step=3, opt_state=state["opt_state"])
        shutil.rmtree(d)
        if dev == "cpu":
            ok = resumed == full[3:]
            how = "bitwise"
        else:
            ok = all(abs(a - b) / abs(b) < F32_TOL
                     for a, b in zip(resumed, full[3:]))
            how = f"within {F32_TOL:g}"
        say(f"  REPRO train() on {dev}, 6 steps with a checkpoint every 3: "
            f"losses {', '.join(f'{x:.6f}' for x in full)}; resumed from "
            f"step {step}: {', '.join(f'{x:.6f}' for x in resumed)} "
            f"({how}: {'yes' if ok else 'NO'})")
        if not (ok and step == 3):
            bad.append(f"resume on {dev}")
    torch.set_num_threads(threads)
    if bad:
        raise SystemExit(f"small-model training checks failed: {bad}")


def small_engine(params, cfg, ds, wl, calib_toks, served):
    """Phase 5's dense-cache path, the checkpoint manager and the
    paged-kernel switch on the CURed f32 model: prefill / decode_step
    logits on the card against the CPU (2e-5); ``generate``'s greedy
    tokens per request on the card == on the CPU == the Server's
    (``served``, dense pool, kernel); the Server with ``paged_kernel="off"``
    on the card gives the same tokens and launches no paged_attention; a
    checkpoint saved from the card restores on the CPU bit-identical."""
    import shutil
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.dist import (
        CheckpointManager, load_tree_template, save_tree_template,
        tree_flatten)
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serve import generate
    from repro_torch.serving import PagedConfig, Server
    cpu_params = tree_map(lambda t: t.cpu(), params)
    toks = ds.batch_at(2)["tokens"][:, :68]            # B 4: 64 + 4 steps
    B, S = toks.shape[0], 64
    rels, logits = [], {}
    c0, f0 = cm.launches, fa.launches
    for dev, prm in (("cuda", params), ("cpu", cpu_params)):
        t = toks.to(dev)
        cache = init_cache(cfg, B, S + 4, dev)
        out, cache = prefill(prm, cfg, {"tokens": t[:, :S]}, cache)
        logits[dev] = [out.cpu()]
        if dev == "cuda":
            torch.cuda.synchronize()
            dcur, dflash = cm.launches - c0, fa.launches - f0
        for j in range(4):
            pos = torch.full((B, 1), S + j, dtype=torch.int32, device=dev)
            step = {"tokens": t[:, S + j:S + j + 1]}
            out, cache = decode_step(prm, cfg, step, cache, pos)
            logits[dev].append(out.cpu())
    rels = [rel_err(a, b) for a, b in zip(logits["cuda"], logits["cpu"])]
    say(f"  dense cache B={B} prefill {S} + 4 decode steps: card vs CPU "
        f"logits rel max {max(rels):.3e} (tol {F32_TOL:g}); prefill "
        f"launches cur_matmul {dcur} flash_attention {dflash}")
    bad = [] if (max(rels) < F32_TOL and dcur > 0 and dflash > 0) else [
        "dense-cache logits"]
    gen = {"cuda": {}, "cpu": {}}
    for i, w in enumerate(wl):
        for dev, prm in (("cuda", params), ("cpu", cpu_params)):
            p = torch.tensor([w["prompt"]], device=dev)
            gen[dev][i] = generate(prm, cfg, p, w["max_new_tokens"]
                                   ).tokens[0].tolist()
    same = gen["cuda"] == gen["cpu"] == served
    say(f"  generate() greedy, {len(wl)} requests one at a time: card, CPU "
        f"and Server tokens {'identical' if same else 'DIFFER'}")
    if not same:
        bad.append("generate tokens")
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    srv = Server(params, cfg, PagedConfig.sized_for(max_len, 4,
                                                   block_size=16),
                 max_concurrency=4, calib_tokens=calib_toks, device="cuda",
                 paged_kernel="off")
    p0 = pa.launches
    off = _serve_all(srv, wl)
    backend = srv.stats()["attn_backends"]["paged_decode"]
    say(f"  Server paged_kernel=off on the card ({backend}): tokens "
        f"{'identical to' if off == served else 'DIFFER from'} the "
        f"kernel's; paged_attention launches {pa.launches - p0}")
    if not (off == served and pa.launches == p0 and backend == "paged_ref"):
        bad.append("paged_kernel off")
    d = os.path.join(ROOT, "build", "chip_smoke_small_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    CheckpointManager(d, keep_n=1).save(0, {"params": params})
    save_tree_template(os.path.join(d, "template.json"), {"params": params})
    step, back = CheckpointManager(d).restore(
        load_tree_template(os.path.join(d, "template.json")), device="cpu")
    mine, ref = tree_flatten(back), tree_flatten({"params": cpu_params})
    exact = len(mine) == len(ref) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(mine, ref))
    shutil.rmtree(d)
    say(f"  checkpoint saved from the card, restored on the CPU: step "
        f"{step}, {len(mine)} leaves, bit-identical {exact}")
    if not exact:
        bad.append("checkpoint card -> CPU")
    if bad:
        raise SystemExit(f"small-model engine checks failed: {bad}")


def _serve_all(srv, wl, chaos=None):
    """Submit every request of ``wl`` at once and drain ``srv`` (then let
    ``chaos`` release what it holds and drain again). Returns {rid:
    tokens}. With every request in the queue from the start, the run's
    steps do not depend on the host's clock."""
    for w in wl:
        srv.submit(w["prompt"], w["max_new_tokens"])
    srv.drain()
    if chaos is not None:
        chaos.finish(srv)
        srv.drain()
    return {k: r.out_tokens for k, r in srv.finished.items()}


def small_spec(params, cfg, wl, calib_toks):
    """Phase 5's speculative serving: the original (single-group) f32
    model, draft self and the 1-layer early exit, k 3, dense and CUR-KV
    pools. Card spec-on tokens must equal card spec-off and CPU spec-on
    tokens."""
    from repro_torch.bridge import tree_map
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.serving import PagedConfig, Server
    from repro_torch.serving.speculative import early_exit_draft
    cpu_params = tree_map(lambda t: t.cpu(), params)
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    bad = []
    for cur_kv in (False, True):
        pc = PagedConfig.sized_for(max_len, 4, block_size=16, cur_kv=cur_kv,
                                   kv_rank=cfg.resolved_head_dim // 2)
        pool = (f"CUR-KV r={pc.rank(cfg.resolved_head_dim)}" if cur_kv
                else "dense")
        off = _serve_all(Server(params, cfg, pc, max_concurrency=4,
                                calib_tokens=calib_toks, device="cuda"), wl)
        for dname in ("self", "self:1"):
            toks = {}
            for dev, prm in (("cuda", params), ("cpu", cpu_params)):
                d, dcfg = ((prm, None) if dname == "self"
                           else early_exit_draft(prm, cfg, 1))
                srv = Server(prm, cfg, pc, max_concurrency=4,
                             calib_tokens=calib_toks, draft_params=d,
                             draft_cfg=dcfg, spec_k=3, device=dev)
                p0 = pa.launches
                toks[dev] = _serve_all(srv, wl)
                if dev == "cuda":
                    st, dpaged = srv.stats(), pa.launches - p0
                    drained = srv.scheduler.alloc.n_free == pc.n_blocks
            same = toks["cuda"] == off == toks["cpu"]
            say(f"  speculative k=3 draft {dname}, {pool} pool: card "
                f"spec-on, card spec-off and CPU spec-on greedy tokens "
                f"{'identical' if same else 'DIFFER'}; accept rate "
                f"{st['spec_accept_rate']:.3f} over "
                f"{st['n_spec_windows']} windows "
                f"({st['n_spec_fallbacks']} fallbacks); paged_attention "
                f"launches {dpaged}")
            if not (same and drained and st["n_spec_windows"] > 0
                    and dpaged > 0):
                bad.append(f"{dname} {pool}")
    if bad:
        raise SystemExit(f"small-model speculative checks failed: {bad}")


def small_chaos(params, cfg, wl, calib_toks, clean):
    """Phase 5's chaos: CHAOS_PLAN on the CURed f32 model (dense pool) on
    the card and on the CPU. Both must give ``clean`` (the chaos-free card
    tokens) and the same fault events, and return every block."""
    from repro_torch.bridge import tree_map
    from repro_torch.serving import PagedConfig, Server
    from repro_torch.testing import ChaosEngine, FaultPlan
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    pc = PagedConfig.sized_for(max_len, 4, block_size=16)
    events, toks, ok = {}, {}, True
    for dev, prm in (("cuda", params),
                     ("cpu", tree_map(lambda t: t.cpu(), params))):
        ch = ChaosEngine(FaultPlan.from_json(CHAOS_PLAN))
        srv = Server(prm, cfg, pc, max_concurrency=4,
                     calib_tokens=calib_toks, chaos=ch, device=dev)
        toks[dev] = _serve_all(srv, wl, ch)
        events[dev] = ch.event_log()
        ok = ok and srv.scheduler.alloc.n_free == pc.n_blocks
        if dev == "cuda":
            faults = srv.stats()["step_faults"]
    kinds = sorted({e["kind"] for e in events["cuda"]})
    same = toks["cuda"] == clean == toks["cpu"]
    same_ev = events["cuda"] == events["cpu"]
    say(f"  chaos plan (seed {CHAOS_PLAN['seed']}): {len(events['cuda'])} "
        f"fault events {kinds}, {faults} step faults; tokens "
        f"{'identical to' if same else 'DIFFER from'} the chaos-free run "
        f"(card and CPU); events card == CPU {same_ev}; pool drained {ok}")
    if not (same and same_ev and ok and set(kinds) == {
            "latency_spike", "pool_squeeze", "transient_error"}):
        raise SystemExit("small-model chaos check failed")


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def phase_main():
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.dist import tree_flatten
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.launch import cure as cure_mod
    from repro_torch.launch.serve import load_draft
    from repro_torch.train.evaluate import perplexity
    say("== phase 6: main path, llama3.1-8b at full width")
    args = cure_mod.parser().parse_args([
        "--arch", "llama3.1-8b", "--layers", "10", "--r-max", "256",
        "--selection", "wanda_deim", "--svd", "randomized",
        "--pipeline", "batched", "--calib-batches", "4",
        "--calib-batch", "4", "--calib-len", "512", "--device", "cuda",
        "--ckpt-dir", CKPT_DIR])
    # every cure() run saves (keep-N 1: the next save holds its .tmp dir
    # beside the last step) and smoke-generates through the Server
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    need = 2 * get_config("llama3.1-8b").param_count() * 2    # bf16, bound
    free = shutil.disk_usage(CKPT_DIR).free
    say(f"  checkpoint dir {os.path.relpath(CKPT_DIR, ROOT)}: {free} bytes "
        f"free, two copies of the full bf16 tree need at most {need}")
    if free < need:
        raise SystemExit(f"not enough disk for the cure() save stage: "
                         f"{free} bytes free, {need} needed")
    # cure() runs CURE_RUNS times on the same seeds. The first run pays
    # the first use of every CUDA kernel and library handle (the linalg of
    # compress above all) and is reported alone; the others give the
    # median and range of each stage. The main path proper is the last
    # run: the counts are set to 0 just before it.
    stages, layers, ckpt_bytes = [], set(), []
    for i in range(CURE_RUNS):
        if i == CURE_RUNS - 1:
            torch.cuda.reset_peak_memory_stats()
            cm.launches = fa.launches = pa.launches = 0
            t0 = time.perf_counter()
        run = cure_mod.cure_run(args)
        stages.append(run.report["stages_s"])
        layers.add(tuple(run.report["layers_compressed"]))
        ckpt_bytes.append(_dir_bytes(CKPT_DIR))
        if i < CURE_RUNS - 1:
            del run
            torch.cuda.empty_cache()
    rep = run.report
    say(f"  cure() cold (run 1 of {CURE_RUNS}): "
        f"{json.dumps(stages[0])}")
    for key in stages[0]:
        warm = sorted(st[key] for st in stages[1:])
        say(f"  cure() warm {key}: median "
            f"{statistics.median(warm)} s, range {warm[0]}-{warm[-1]} s "
            f"over {len(warm)} runs")
    rates = [b / st["save"] / 1e9 for b, st in zip(ckpt_bytes, stages)]
    say(f"  save stage: checkpoint {ckpt_bytes[-1]} bytes on disk "
        f"(step dir + template.json); {rates[0]:.3f} GB/s cold, warm "
        f"{', '.join(f'{r:.3f}' for r in rates[1:])} GB/s")
    g = run.report["generate"]
    say(f"  generate stage (last run): {g['tokens']} tokens via "
        f"{g['engine']}, {g['tok_per_s']} tok/s")
    ds = SyntheticLM(DataConfig(run.cfg.vocab_size, 512, 4, seed=1),
                     "cuda")
    evl = [ds.batch_at(1000 + i) for i in range(2)]
    ppl_orig = perplexity(run.params, run.cfg, evl)
    torch.cuda.synchronize()
    main_cur, main_flash, main_paged = cm.launches, fa.launches, pa.launches
    cm.launches = 0
    fa.launches = 0
    t1 = time.perf_counter()
    ppl_cur = perplexity(run.cured_params, run.cured_cfg, evl)
    torch.cuda.synchronize()
    t_fold_ppl = time.perf_counter() - t1
    fold_cur, fold_flash = cm.launches, fa.launches
    from repro_torch.models import forward
    logits = forward(run.cured_params, run.cured_cfg, evl[0])
    torch.cuda.synchronize()
    # restore through template.json onto the card, with the function that
    # serve's --draft DIR calls; the restored tree is phase 7's draft
    t2 = time.perf_counter()
    step, draft, draft_cfg = load_draft(CKPT_DIR, run.cfg, "cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t2
    mine, ref = tree_flatten(draft), tree_flatten(run.cured_params)
    leaves_equal = len(mine) == len(ref) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(mine, ref))
    logits_equal = torch.equal(forward(draft, draft_cfg, evl[0]), logits)
    restored_bytes = sum(t.numel() * t.element_size() for t in mine)
    shutil.rmtree(CKPT_DIR)
    say(f"  restore (load_draft) of step {step}: {len(mine)} leaves, "
        f"{restored_bytes} bytes in {t_restore:.3f} s "
        f"({restored_bytes / t_restore / 1e9:.3f} GB/s); every leaf "
        f"torch.equal {leaves_equal}; folded logits on evl[0] torch.equal "
        f"{logits_equal}; checkpoint dir deleted")
    worst = max(rep["weights"], key=lambda w: w["rel_fro_err"])
    say(f"  depth {rep['n_layers']} of 32 (no depth cut), d_model "
        f"{run.cfg.d_model}, vocab {run.cfg.vocab_size}, "
        f"{run.cfg.dtype}")
    say(f"  stages_s of the main-path run {json.dumps(rep['stages_s'])}")
    say(f"  layers_compressed {rep['layers_compressed']} "
        f"({rep['n_weights']} weights)")
    say(f"  params model_total {rep['params']['model_total']} "
        f"saved_deployed {rep['params']['saved_deployed']} "
        f"-> {rep['params']['model_total'] - rep['params']['saved_deployed']}"
        f" ({rep['params']['reduction_pct_model']}%)")
    say(f"  worst rel_fro_err {worst['rel_fro_err']} (layer "
        f"{worst['layer']} {worst['name']})")
    say(f"  perplexity original {ppl_orig:.6f} folded {ppl_cur:.6f} "
        f"(2 x 4 x 512 held-out synthetic tokens); folded pass "
        f"{t_fold_ppl:.3f} s")
    say(f"  folded logits {tuple(logits.shape)} finite "
        f"{bool(torch.isfinite(logits).all())}")
    say(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; wall {time.perf_counter() - t0:.1f} s")
    say(f"  launches cure+original perplexity: cur_matmul {main_cur} "
        f"flash_attention {main_flash} paged_attention {main_paged}; "
        f"folded perplexity pass: cur_matmul {fold_cur} flash_attention "
        f"{fold_flash}")
    checks = {
        "saved_deployed == 715653120":
            rep["params"]["saved_deployed"] == 715_653_120,
        "10 layers compressed": len(rep["layers_compressed"]) == 10,
        "every cure() run chose the same layers": len(layers) == 1,
        "finite perplexities":
            math.isfinite(ppl_orig) and math.isfinite(ppl_cur),
        "logits finite, (4, 512, V)":
            tuple(logits.shape) == (4, 512, run.cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
        "cur_matmul launched on the folded pass": fold_cur > 0,
        "flash_attention launched on the folded pass": fold_flash > 0,
        "stages_s has save and generate": all(
            {"save", "generate"} <= set(st) for st in stages),
        "generate: 4 x 8 tokens via serving": g["engine"] == "serving"
            and g["tokens"] == 4 * 8,
        "paged_attention launched by the generate stage": main_paged > 0,
        "restored checkpoint: every leaf torch.equal": leaves_equal,
        "restored checkpoint: folded logits torch.equal": logits_equal,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"main path checks failed: {bad}")
    return ({"cur_matmul": main_cur + fold_cur,
             "flash_attention": main_flash + fold_flash,
             "paged_attention": main_paged}, run, (draft, draft_cfg),
            ppl_cur)


def _prefill_logits(params, cfg, pc, cache, prompt):
    """Last-position logits (V,) of ``prompt`` through the Server's own
    prefill path (runtime.paged_prefill, slot 0 of 8, pow-2 bucket) into
    ``cache``."""
    import numpy as np
    import torch
    from repro_torch.serving import runtime
    B, S = 8, 16
    while S < len(prompt):
        S *= 2
    toks = np.zeros((B, S), np.int64)
    toks[0, :len(prompt)] = prompt
    lengths = np.zeros((B,), np.int64)
    lengths[0] = len(prompt)
    table = np.full((B, pc.max_blocks_per_seq), -1, np.int32)
    nblk = pc.blocks_for(len(prompt) + 1)
    table[0, :nblk] = np.arange(nblk)
    logits, _ = runtime.paged_prefill(
        params, cfg, pc, torch.from_numpy(toks), torch.from_numpy(lengths),
        cache, torch.from_numpy(table))
    return logits[0]


def _workloads(V):
    """Phase 7's workloads. A: the serve CLI's make_workload (prompts
    8-40, budgets 4-32, arrivals 20 ms apart); B: a loadgen burst of 16,
    prompts 256 / 512 / 1024, 64 new tokens each."""
    from repro_torch.launch.serve import make_workload
    from repro_torch.obs import loadgen
    return {
        "A": make_workload(16, V, max_new=32),
        "B": loadgen.generate(loadgen.WorkloadSpec(
            n_requests=16, arrival="burst",
            prompt=loadgen.LengthDist(kind="choice",
                                      values=(256, 512, 1024)),
            gen=loadgen.LengthDist(kind="fixed", mean=64, hi=64),
            vocab_size=V, seed=0)),
    }


def phase_serve(run, draft):
    """The CURed model of the last cure() run served on the card;
    ``draft`` is (params, cfg) of its checkpoint as phase 6 restored it."""
    import numpy as np
    import torch
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.launch.serve import run_continuous
    from repro_torch.models import forward
    from repro_torch.serving import PagedConfig, Server, runtime
    from repro_torch.serving import paged_cache as pcache
    say("== phase 7: serve, llama3.1-8b at full width (CURed, bf16)")
    params, cfg = run.cured_params, run.cured_cfg
    workloads = _workloads(cfg.vocab_size)
    launches = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    bad = []
    base = {}                       # spec-off tokens by (workload, cur_kv)
    for wname, wl in workloads.items():
        max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
        for cur_kv in (False, True):
            pc = PagedConfig.sized_for(max_len, 8, block_size=16,
                                       cur_kv=cur_kv, kv_rank=KV_RANK)
            srv = Server(params, cfg, pc, max_concurrency=8, device="cuda")
            torch.cuda.synchronize()
            cm.launches = fa.launches = pa.launches = 0
            finished, st = run_continuous(srv, wl, verbose=False)
            torch.cuda.synchronize()
            base[wname, cur_kv] = {k: r.out_tokens
                                   for k, r in finished.items()}
            n = {"cur_matmul": cm.launches, "flash_attention": fa.launches,
                 "paged_attention": pa.launches}
            for k in launches:
                launches[k] += n[k]
            snap = srv.obs.snapshot()
            step_p50 = snap["repro_serving_decode_step_s"]["p50"]
            label = (f"{wname} {'CUR-KV r=' + str(KV_RANK) if cur_kv else 'dense'}")
            say(f"  {label}: {len(wl)} requests, {st['tokens_generated']} "
                f"tokens, {st['tokens_per_s']:.1f} tok/s (busy "
                f"{st['tokens_per_s_busy']:.1f}); TTFT p50 "
                f"{st['ttft_p50_s'] * 1e3:.1f} p99 "
                f"{st['ttft_p99_s'] * 1e3:.1f} ms; TPOT p50 "
                f"{st['tpot_p50_s'] * 1e3:.2f} p99 "
                f"{st['tpot_p99_s'] * 1e3:.2f} ms; decode window step "
                f"median {step_p50 * 1e3:.2f} ms; steps prefill "
                f"{st['n_prefill_steps']} decode {st['n_decode_steps']}; "
                f"pool {st['cache_bytes']} bytes "
                f"({pc.n_blocks} blocks); gathered "
                f"{st['gathered_bytes_per_step']} bytes/step; launches "
                f"{json.dumps(n)}")
            checks = {
                "every request finished by length": len(finished) == len(wl)
                and all(r.finish_reason == "length"
                        for r in finished.values()),
                "paged_attention launches == decode steps x 32":
                    n["paged_attention"] == st["n_decode_steps"]
                    * cfg.n_layers,
                "flash_attention launched": n["flash_attention"] > 0,
                "cur_matmul launched": n["cur_matmul"] > 0,
                "allocator drained": srv.scheduler.alloc.n_free
                    == pc.n_blocks,
                "nothing gathered": st["gathered_bytes_per_step"] == 0,
            }
            if not cur_kv:
                # prefill logits of request 0 against the folded forward
                prompt = wl[0]["prompt"]
                cache = pcache.init_paged_cache(cfg, pc, "cuda")
                logits = _prefill_logits(params, cfg, pc, cache, prompt)
                ref = forward(params, cfg, {"tokens": torch.tensor(
                    [prompt], device="cuda")})[0, -1]
                rel = rel_err(logits, ref)
                say(f"  {label}: request 0 prefill logits vs folded "
                    f"forward() rel {rel:.3e} (tol {BF16_TOL:g})")
                checks["prefill logits match forward()"] = rel < BF16_TOL
                del cache
            for k, ok in checks.items():
                if not ok:
                    bad.append(f"{label}: {k}")
            del srv
            torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f"serve checks failed: {bad}")
    spec_launches, stats_a = serve_spec(run, workloads, base, draft)
    for k, v in spec_launches.items():
        launches[k] += v
    for k, v in serve_chaos(params, cfg, workloads["A"]).items():
        launches[k] += v
    for k, v in serve_legacy(params, cfg).items():
        launches[k] += v
    profile_decode(params, cfg, workloads["B"])
    return launches, stats_a


def _drive_sampled(srv, wl, temperature, top_p):
    """loadgen.drive with top-p: submit each request at its arrival offset
    (SamplingParams(temperature, top_p, seed = its index)) and step until
    everything drains."""
    from repro_torch.serving import SamplingParams
    t0, i = time.perf_counter(), 0
    while i < len(wl) or not srv.idle:
        now = time.perf_counter()
        while i < len(wl) and t0 + wl[i]["arrival_offset_s"] <= now:
            srv.submit(wl[i]["prompt"], wl[i]["max_new_tokens"],
                       sampling=SamplingParams(temperature=temperature,
                                               top_p=top_p, seed=i),
                       arrival=t0 + wl[i]["arrival_offset_s"])
            i += 1
        if not srv.step() and i < len(wl):
            time.sleep(max(0.0, t0 + wl[i]["arrival_offset_s"]
                           - time.perf_counter()))
    return srv.finished, srv.stats()


def _agreement(target, cfg, pc, wl, spec, off):
    """Token agreement of a speculative run with its spec-off run: matching
    positions over all tokens, identical requests, and at the first
    diverging request the position and the target's logits there (prompt
    + the common prefix through a fresh Server's prefill path, its pool
    calibrated as the runs' were): the top-2 margin and the gap between
    the two runs' tokens."""
    import torch
    from repro_torch.serving import Server
    same_pos = sum(sum(a == b for a, b in zip(spec[i], off[i])) for i in off)
    total = sum(len(off[i]) for i in off)
    same_req = sum(spec[i] == off[i] for i in off)
    text = (f"agreement with spec-off {same_pos}/{total} tokens, "
            f"{same_req}/{len(off)} requests identical")
    for i in sorted(off):
        if spec[i] != off[i]:
            p = next(j for j, (a, b) in enumerate(zip(spec[i], off[i]))
                     if a != b)
            srv = Server(target, cfg, pc, max_concurrency=8, device="cuda")
            lg = _prefill_logits(target, cfg, pc, srv.cache,
                                 wl[i]["prompt"] + off[i][:p]).float()
            del srv
            top = torch.topk(lg, 2)
            text += (f"; first divergence request {i} token {p}: spec "
                     f"{spec[i][p]} vs off {off[i][p]}; prefill-path logits "
                     f"there: top-2 margin "
                     f"{float(top.values[0] - top.values[1]):.4f} (tokens "
                     f"{top.indices.tolist()}), spec minus off "
                     f"{float(lg[spec[i][p]] - lg[off[i][p]]):.4f}")
            break
    return text


def serve_spec(run, workloads, base, draft):
    """Speculative serving at full width, spec_k 4, max_concurrency 8,
    block 16: (a) the original model drafted by the CURed one (the
    in-memory form of the --emit-draft companion), workload B, dense pool,
    greedy, with the same target's spec-off run; (a') (a) with the draft
    restored from cure()'s checkpoint (``draft``, by serve's --draft DIR
    function): its accept rate and tokens must equal (a)'s; (b) the CURed
    model drafted by itself, workload B, CUR-KV pool r 64, greedy; (c) (a)
    on workload A at temperature 0.8, top-p 0.95. Returns the kernels'
    launches over the runs."""
    import torch
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serving import PagedConfig, Server
    from repro_torch.serving import speculative
    launches = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    bad = []
    drawing = [0.0]           # host seconds in the window draws, run (c)
    draw = speculative.window_uniforms

    def timed_draw(*a, **kw):
        t0 = time.perf_counter()
        out = draw(*a, **kw)
        drawing[0] += time.perf_counter() - t0
        return out

    def pool(wl, cur_kv):
        max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
        return PagedConfig.sized_for(max_len, 8, block_size=16,
                                     cur_kv=cur_kv, kv_rank=KV_RANK)

    # the original model's spec-off tokens on workload B, for (a)
    wl_b = workloads["B"]
    srv = Server(run.params, run.cfg, pool(wl_b, False), max_concurrency=8,
                 device="cuda")
    cm.launches = fa.launches = pa.launches = 0
    finished, st = run_continuous(srv, wl_b, verbose=False)
    torch.cuda.synchronize()
    for k, v in (("cur_matmul", cm.launches), ("flash_attention",
                 fa.launches), ("paged_attention", pa.launches)):
        launches[k] += v
    off_a = {k: r.out_tokens for k, r in finished.items()}
    say(f"  B dense, original model, spec off: {st['tokens_generated']} "
        f"tokens, {st['tokens_per_s']:.1f} tok/s; TPOT p50 "
        f"{st['tpot_p50_s'] * 1e3:.2f} p99 {st['tpot_p99_s'] * 1e3:.2f} ms")
    del srv
    torch.cuda.empty_cache()

    runs = [
        ("(a) B dense, original model, draft = CURed model", run.params,
         run.cfg, run.cured_params, run.cured_cfg, "B", False, None, off_a),
        ("(a') (a) with the draft restored from the checkpoint", run.params,
         run.cfg, draft[0], draft[1], "B", False, None, off_a),
        ("(b) B CUR-KV r=64, CURed model, draft self", run.cured_params,
         run.cured_cfg, run.cured_params, None, "B", True, None,
         base["B", True]),
        ("(c) A dense, original model, draft = CURed model, T 0.8 "
         "top-p 0.95", run.params, run.cfg, run.cured_params,
         run.cured_cfg, "A", False, (0.8, 0.95), None),
    ]
    for label, tgt, tcfg, drf, dcfg, wname, cur_kv, smp, off in runs:
        wl = workloads[wname]
        pc = pool(wl, cur_kv)
        srv = Server(tgt, tcfg, pc, max_concurrency=8, draft_params=drf,
                     draft_cfg=dcfg, spec_k=SPEC_K, device="cuda")
        torch.cuda.synchronize()
        cm.launches = fa.launches = pa.launches = 0
        if smp is None:
            finished, st = run_continuous(srv, wl, verbose=False)
        else:
            speculative.window_uniforms = timed_draw
            try:
                finished, st = _drive_sampled(srv, wl, *smp)
            finally:
                speculative.window_uniforms = draw
        torch.cuda.synchronize()
        n = {"cur_matmul": cm.launches, "flash_attention": fa.launches,
             "paged_attention": pa.launches}
        for k in launches:
            launches[k] += n[k]
        toks = {k: r.out_tokens for k, r in finished.items()}
        if label.startswith("(a')"):
            same_a = (toks == run_a[0]
                      and st["spec_accept_rate"] == run_a[1])
            agree = (f"tokens and accept rate equal to (a)'s (the same "
                     f"draft bits): {same_a}")
        elif off is not None:
            agree = _agreement(tgt, tcfg, pc, wl, toks, off)
        else:
            agree = "agreement with spec-off: not compared (sampled)"
        if label.startswith("(a)"):
            run_a = (toks, st["spec_accept_rate"])
            stats_a = st
        say(f"  {label}: {len(wl)} requests, {st['tokens_generated']} "
            f"tokens, {st['tokens_per_s']:.1f} tok/s (busy "
            f"{st['tokens_per_s_busy']:.1f}); TTFT p50 "
            f"{st['ttft_p50_s'] * 1e3:.1f} p99 {st['ttft_p99_s'] * 1e3:.1f} "
            f"ms; TPOT p50 {st['tpot_p50_s'] * 1e3:.2f} p99 "
            f"{st['tpot_p99_s'] * 1e3:.2f} ms; accept rate "
            f"{st['spec_accept_rate']:.4f} over {st['n_spec_windows']} "
            f"windows ({st['n_spec_fallbacks']} fallbacks); draft "
            f"{st['spec_draft_time_s']:.3f} s verify "
            f"{st['spec_verify_time_s']:.3f} s (device, CUDA events); "
            f"launches {json.dumps(n)}")
        say(f"    {agree}")
        if smp is not None:
            say(f"    host time drawing the windows' uniforms (one seeded "
                f"generator per draw): {drawing[0]:.4f} s of "
                f"{st['decode_time_s']:.3f} s in decode steps "
                f"({drawing[0] / st['decode_time_s']:.4f})")
        alloc = srv.scheduler.alloc
        checks = {
            "every request finished by length": len(finished) == len(wl)
            and all(r.finish_reason == "length" for r in finished.values()),
            "allocator back to 0 used blocks": alloc.used == 0
            and alloc.n_free == pc.n_blocks,
            "speculative windows ran": st["n_spec_windows"] > 0,
            "paged_attention launches >= windows x layers x 2":
                n["paged_attention"]
                >= st["n_spec_windows"] * tcfg.n_layers * 2,
        }
        if label.startswith("(a')"):
            checks["tokens and accept rate equal (a)'s"] = same_a
        bad += [f"{label}: {k}" for k, ok in checks.items() if not ok]
        del srv
        torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f"speculative serve checks failed: {bad}")
    return launches, stats_a


def serve_legacy(params, cfg):
    """The static-batch engine (serve --legacy's ``generate``) on the CURed
    model: 8 SyntheticLM prompts of 512 tokens, 64 new tokens, greedy.
    Prints prefill wall, decode wall per step, tokens/s and the dense
    cache's bytes; checks the prefill logits and the decode logits at
    steps 1, 16 and 63 against ``forward()`` over the grown sequence
    (2e-2, bf16) and that the prefill launched cur_matmul and
    flash_attention. Then serves the same prompts through the Server and
    prints the greedy agreement (not checked: bf16 near-ties). Returns the
    kernels' launches over both runs."""
    import torch
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.dist import tree_flatten
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models import forward
    from repro_torch.serve import engine
    from repro_torch.serving import PagedConfig, Server
    B, S, n_new = ENGINE_SHAPE
    prompts = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=2),
                          "cuda").batch_at(0)["tokens"]
    rec = {"steps": 0, "logits": {}}
    real_prefill, real_decode = engine.prefill, engine.decode_step

    def prefill(prm, c, batch, cache, mesh=None):
        torch.cuda.synchronize()
        c0, f0 = cm.launches, fa.launches
        t0 = time.perf_counter()
        out = real_prefill(prm, c, batch, cache, mesh)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
        rec["prefill_launches"] = (cm.launches - c0, fa.launches - f0)
        rec["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tree_flatten(cache))
        rec["logits"][0] = out[0].clone()
        return out

    def decode_step(prm, c, batch, cache, pos, mesh=None):
        out = real_decode(prm, c, batch, cache, pos, mesh)
        rec["steps"] += 1
        if rec["steps"] in ENGINE_CHECK_STEPS:
            rec["logits"][rec["steps"]] = out[0].clone()
        return out

    engine.prefill, engine.decode_step = prefill, decode_step
    torch.cuda.synchronize()
    cm.launches = fa.launches = pa.launches = 0
    try:
        t0 = time.perf_counter()
        out = engine.generate(params, cfg, prompts, n_new)
        toks = out.tokens.cpu()
        wall = time.perf_counter() - t0
    finally:
        engine.prefill, engine.decode_step = real_prefill, real_decode
    launches = {"cur_matmul": cm.launches, "flash_attention": fa.launches,
                "paged_attention": pa.launches}
    decode_s = wall - rec["prefill_s"]
    seq = torch.cat([prompts, out.tokens[:, :n_new - 1]], dim=1)
    full = forward(params, cfg, {"tokens": seq})
    rels = {t: rel_err(lg, full[:, S - 1 + t])
            for t, lg in sorted(rec["logits"].items())}
    del full
    say(f"  legacy engine generate(): B={B} prompts of {S} tokens, {n_new} "
        f"new (greedy): prefill {rec['prefill_s'] * 1e3:.1f} ms, decode "
        f"{decode_s:.3f} s = {decode_s * 1e3 / rec['steps']:.2f} ms per "
        f"step over {rec['steps']} steps, {toks.numel() / wall:.1f} tok/s "
        f"(wall {wall:.3f} s); dense cache {rec['cache_bytes']} bytes; "
        f"prefill launches cur_matmul {rec['prefill_launches'][0]} "
        f"flash_attention {rec['prefill_launches'][1]}; run launches "
        f"{json.dumps(launches)}")
    say(f"  legacy engine logits vs forward() over the grown sequence "
        f"(0 = prefill): " + ", ".join(f"step {t} rel {r:.3e}"
                                       for t, r in rels.items())
        + f" (tol {BF16_TOL:g})")
    srv = Server(params, cfg, PagedConfig.sized_for(S + n_new, B,
                                                   block_size=16),
                 max_concurrency=B, device="cuda")
    p0 = pa.launches
    for row in prompts.tolist():
        srv.submit(row, n_new)
    srv.drain()
    launches["paged_attention"] += pa.launches - p0
    served = [srv.finished[i].out_tokens for i in range(B)]
    same = sum(a == b for i in range(B)
               for a, b in zip(toks[i].tolist(), served[i]))
    say(f"  legacy engine vs Server (paged, same prompts, greedy): "
        f"{same}/{B * n_new} tokens agree, "
        f"{sum(toks[i].tolist() == served[i] for i in range(B))}/{B} "
        f"requests identical (printed, not checked: bf16 near-ties)")
    del srv
    torch.cuda.empty_cache()
    checks = {
        "logits within 2e-2 of forward()": len(rels) == 1 + len(
            ENGINE_CHECK_STEPS) and max(rels.values()) < BF16_TOL,
        "cur_matmul launched in the prefill": rec["prefill_launches"][0] > 0,
        "flash_attention launched in the prefill":
            rec["prefill_launches"][1] > 0,
        "tokens (8, 64)": tuple(toks.shape) == (B, n_new),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"legacy engine checks failed: {bad}")
    return launches


def serve_chaos(params, cfg, wl):
    """CHAOS_PLAN_7 on workload A (all requests queued at once) served by
    the CURed model, run twice from the same plan: the same fault events
    both times, every original request finished, the pool drained."""
    import torch
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.serving import PagedConfig, Server
    from repro_torch.testing import ChaosEngine, FaultPlan
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    pc = PagedConfig.sized_for(max_len, 8, block_size=16)
    launches = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    runs = []
    for _ in range(2):
        ch = ChaosEngine(FaultPlan.from_json(CHAOS_PLAN_7))
        srv = Server(params, cfg, pc, max_concurrency=8, chaos=ch,
                     device="cuda")
        cm.launches = fa.launches = pa.launches = 0
        toks = _serve_all(srv, wl, ch)
        torch.cuda.synchronize()
        for k, v in (("cur_matmul", cm.launches), ("flash_attention",
                     fa.launches), ("paged_attention", pa.launches)):
            launches[k] += v
        done = all(srv.finished[i].finish_reason == "length"
                   for i in range(len(wl)))
        runs.append((ch.event_log(), toks, done,
                     srv.scheduler.alloc.used == 0, srv.stats()))
        del srv
        torch.cuda.empty_cache()
    (ev1, t1, done1, drained1, st), (ev2, t2, done2, drained2, _) = runs
    kinds = sorted({e["kind"] for e in ev1})
    say(f"  chaos A (seed {CHAOS_PLAN_7['seed']}), twice: "
        f"{len(ev1)} / {len(ev2)} fault events {kinds}, "
        f"{st['step_faults']} step faults, {len(t1)} requests "
        f"(storm included); events identical {ev1 == ev2}; tokens "
        f"identical {t1 == t2}; every original request finished "
        f"{done1 and done2}; pool drained {drained1 and drained2}")
    if not (ev1 == ev2 and ev1 and done1 and done2 and drained1
            and drained2):
        raise SystemExit("chaos serve checks failed")
    return launches


def _counts():
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    return {"cur_matmul": cm.launches, "flash_attention": fa.launches,
            "paged_attention": pa.launches}


def _zero_counts():
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    cm.launches = fa.launches = pa.launches = 0


def phase_train(run):
    """Phase 9: training and healing at full width, then the trained-weights
    pipeline. Each part is driven with the counts set to 0 just before it
    and read just after. Returns the summed counts, 9b's heal step (for
    phase 8's trace) and 9c's trained model (for phase 10e)."""
    import torch
    say("== phase 9: training and healing on the card")
    total = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    failed, kept = [], {}
    for name, part in (("9a", train_olmo), ("9b", lambda: heal_llama(run)),
                       ("9c", trained_repro)):
        torch.cuda.synchronize()
        _zero_counts()
        out = part()
        if isinstance(out, tuple):
            out, kept[name] = out
        failed += out
        torch.cuda.synchronize()
        for k, v in _counts().items():
            total[k] += v
        torch.cuda.empty_cache()
    say(f"  phase 9 launches {json.dumps(total)}")
    if failed:
        raise SystemExit(f"training checks failed: {failed}")
    return total, kept.get("9b"), kept.get("9c")


def _flash_per_step(cfg):
    """flash_attention launches of one training step: one a layer, and
    one more where remat recomputes the layer's body in the backward
    (``cfg.remat`` on a scanned group of several repeats, or
    ``static_loops``)."""
    remat = cfg.remat and any((cfg.scan_layers and reps > 1)
                              or cfg.static_loops for _, reps in cfg.groups)
    return cfg.n_layers * (2 if remat else 1)


def train_olmo():
    """9a: olmo-1b at full width (random weights, bf16), eight steps of the
    train CLI's path (``launch.train.run``) at batch 8 x 128 tokens, the
    CLI's defaults otherwise."""
    import torch
    from repro_torch.dist import tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_params
    args = train_cli.parser().parse_args([
        "--arch", "olmo-1b", "--steps", "8", "--batch", "8", "--seq-len",
        "128", "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    tr = train_cli.run(args)
    wall = time.perf_counter() - t0
    cfg = tr.cfg
    n_params = sum(t.numel() for t in tree_flatten(tr.params))
    steps_ms = [1e3 * t for t in tr.watchdog._times]
    say(f"  9a olmo-1b ({cfg.n_layers} L, d {cfg.d_model}, H {cfg.n_heads} "
        f"K {cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, ff {cfg.d_ff}, V "
        f"{cfg.vocab_size}, {cfg.dtype}, {n_params} parameters), batch "
        f"{args.batch} x {args.seq_len} tokens, {args.steps} steps in "
        f"{wall:.2f} s")
    say(f"    losses {', '.join(f'{x:.4f}' for x in tr.losses)}")
    say(f"    step ms {', '.join(f'{x:.1f}' for x in steps_ms)} (median of "
        f"steps 2-8 {statistics.median(steps_ms[1:]):.1f} ms)")
    say(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB ({base:.2f} GiB held before, phase 6's model); "
        f"flash_attention launches {fa.launches} "
        f"({fa.launches / args.steps:g} per step; remat "
        f"{cfg.remat_policy if cfg.remat else 'off'})")
    # every weight moved: against a fresh init from the same seed, leaf by
    # leaf and layer by layer
    init = init_params(0, cfg, "cuda")
    same = [i for i, (a, b) in enumerate(zip(tree_flatten(init),
                                             tree_flatten(tr.params)))
            if (a.dim() == 3 and any(torch.equal(x, y)
                                     for x, y in zip(a, b)))
            or torch.equal(a, b)]
    del init
    checks = {
        "every loss finite": all(math.isfinite(x) for x in tr.losses),
        "every weight moved": not same,
        "flash_attention 16 per step (32 under remat: each layer's "
        "forward again in the backward)":
            fa.launches == _flash_per_step(cfg) * args.steps,
        "Adam step count 8": int(tr.opt_state["step"]) == args.steps,
    }
    return [f"9a: {k}" for k, ok in checks.items()
            if not ok]


def heal_llama(run):
    """9b: llama3.1-8b at full width (phase 6's dense params, bf16; ``run``
    None: the same seed's, made here) CURed in healing form (phase 6's 10
    layers, r_max 256, fold_u off), then eight
    dU-only KD heal steps (alpha 0.1, T 10, AdamW lr 3e-4) on batch 2 x 512
    tokens."""
    import torch
    from repro_torch.attention import registry
    from repro_torch.configs.base import CURConfig, OptimizerConfig
    from repro_torch.core import calibrate, compress_model, heal
    from repro_torch.core.peft import count_trainable
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.dist import tree_flatten
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import forward_hidden
    from repro_torch.optim.adamw import AdamW
    if run is None:       # phase 6 not run: cure()'s seed-0 weights
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        cfg = get_config("llama3.1-8b")
        teacher, layers = init_params(0, cfg, "cuda"), None
    else:
        cfg, teacher = run.cfg, run.params
        layers = run.report["layers_compressed"]
    t0 = time.perf_counter()
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 512, 4, seed=0), "cuda")
    calib = calibrate(teacher, cfg, [ds.batch_at(i) for i in range(4)])
    student, scfg, info = compress_model(teacher, cfg, CURConfig(
        r_max=256, n_compress_layers=10, selection="wanda_deim",
        svd="randomized", fold_u=False, pipeline="batched"), calib,
        layers=layers)
    del calib
    torch.cuda.synchronize()
    t_cure = time.perf_counter() - t0
    mask = heal.trainable_mask(student, "dU")
    n_train = count_trainable(student, mask)
    tr, fr = heal.partition_params(student, mask)
    opt = AdamW(OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=8))
    step = heal.make_heal_step(scfg, cfg, teacher, opt, alpha=0.1, temp=10.0)
    hds = SyntheticLM(DataConfig(cfg.vocab_size, 512, 2, seed=2), "cuda")
    batches = [hds.batch_at(i) for i in range(8)]

    say(f"  9b llama3.1-8b heal: {len(info.weights)} weights of layers "
        f"{info.layers} CURed in healing form (r_max 256) in {t_cure:.1f} s; "
        f"{n_train} trainable parameters (dU)")
    labels = [f"{li}:{name}" for li, group in enumerate(student["groups"])
              for name in sorted(group[0]) if isinstance(group[0][name], dict)
              and "dU" in group[0][name]]

    # step 0's dU gradients by three attention routes: the kernel
    # (FlashAttentionFn), the plain route (the flash adaptor calling the
    # kernel's plain version under autograd) and, for the noise floor of
    # two plain bf16 routes, the registry's dense backend
    def du_grads():
        with torch.no_grad():
            t_log, t_hid = forward_hidden(teacher, cfg, batches[0])
        loss, g = heal.value_and_grad(lambda t: heal.kd_loss_fn(
            heal.combine_params(t, fr), scfg, batches[0], t_log, t_hid,
            alpha=0.1, temp=10.0), tr)
        return float(loss), tree_flatten(g)

    f0 = fa.launches
    lk, gk = du_grads()
    per_pass = fa.launches - f0
    kernel_op = fa_ops.flash_attention_op
    fa_ops.flash_attention_op = (
        lambda q, k, v, *, causal=True, window=0, scale=None:
        flash_attention_ref(q, k, v, causal=causal, window=window,
                            scale=scale))
    f1 = fa.launches
    try:
        lp, gp = du_grads()
    finally:
        fa_ops.flash_attention_op = kernel_op
    flash_be = registry._REGISTRY["mix"].pop(0)
    try:
        ld, gd = du_grads()
    finally:
        registry._REGISTRY["mix"].insert(0, flash_be)
    plain_launches = fa.launches - f1
    kp = [rel_err(a, b) for a, b in zip(gk, gp)]
    dp = [rel_err(a, b) for a, b in zip(gd, gp)]
    top = max(float(b.abs().max()) for b in gp)

    def whole(x, y):
        return rel_err(torch.cat([a.flatten() for a in x]),
                       torch.cat([b.flatten() for b in y]))
    # the bound is held on the whole dU gradient (all leaves as one
    # array): leaf by leaf, two plain bf16 routes already disagree by more
    # than 2e-2 on the small wq / wk gradients, so there the kernel route
    # is held to the plain routes' own spread
    grad_whole = whole(gk, gp)
    say(f"    step 0 dU gradients: KD loss kernel {lk:.6f}, plain {lp:.6f}, "
        f"dense {ld:.6f}; all {len(gk)} as one array, kernel vs plain "
        f"{grad_whole:.3e} (tol {BF16_TOL:g}), dense vs plain "
        f"{whole(gd, gp):.3e}; per leaf, rel max kernel vs plain "
        f"{max(kp):.3e}, dense vs plain {max(dp):.3e}; flash_attention "
        f"launches {per_pass} (teacher + student forwards), plain routes "
        f"{plain_launches}")
    say("      largest per leaf (kernel vs plain | dense vs plain; leaf "
        "max|g| / all max|g|): " + "; ".join(
            f"{labels[i]} {kp[i]:.2e} | {dp[i]:.2e}; "
            f"{float(gp[i].abs().max()) / top:.2e}"
            for i in sorted(range(len(kp)), key=lambda i: -kp[i])[:4]))
    del gk, gp, gd
    frozen_before = [t.clone() for t in tree_flatten(fr)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    losses, ms, launches = [], [], []
    du0 = [t.clone() for t in tree_flatten(tr)]
    opt_state = opt.init(tr)
    for b in batches:
        f0 = fa.launches
        t1 = time.perf_counter()
        tr, opt_state, loss = step(tr, fr, opt_state, b)
        losses.append(float(loss))
        ms.append(1e3 * (time.perf_counter() - t1))
        launches.append(fa.launches - f0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"    KD losses {', '.join(f'{x:.4f}' for x in losses)}")
    say(f"    step ms {', '.join(f'{x:.1f}' for x in ms)} (median of steps "
        f"2-8 {statistics.median(ms[1:]):.1f} ms); peak memory {peak:.2f} "
        f"GiB ({base:.2f} GiB held before: teacher, student factors, the "
        f"frozen leaves' copies for the check); flash_attention launches "
        f"per step {launches}")
    frozen_same = all(torch.equal(a, b) for a, b in zip(
        frozen_before, tree_flatten(fr)))
    du_moved = all(not torch.equal(a, b) for a, b in zip(
        du0, tree_flatten(tr)))
    del frozen_before, du0
    checks = {
        "30 dU of 256^2 = 1,966,080 trainable": n_train == 30 * 256 * 256,
        "every loss finite": all(math.isfinite(x) for x in losses),
        "every frozen leaf torch.equal to before": frozen_same,
        "every dU moved": du_moved,
        "step 0 dU gradient kernel vs plain route (one array)":
            grad_whole < BF16_TOL,
        "step 0 dU gradients per leaf within the plain routes' spread":
            max(kp) <= max(dp),
        "flash_attention 32 per student + 32 per teacher forward":
            per_pass == 2 * cfg.n_layers and plain_launches == 0 and
            all(n == 2 * cfg.n_layers for n in launches),
    }
    failed = [f"9b: {k}" for k, ok in checks.items() if not ok]
    return failed, (step, tr, fr, opt_state, batches[0])


def trained_repro():
    """9c: the paper's Fig. 4/5 pipeline on the trained REPRO model
    (examples/train_compress_heal.py): ``zoo.get_trained_repro(300)`` into
    build/ (deleted after), calibrate, CUR 3 layers at r_max 64, 40 heal
    steps; perplexity at each stage through the folded model (cur_matmul);
    then the trained model served with an early-exit self-draft
    (``--draft self:2 --spec-k 4``): its accept rate."""
    import shutil
    import torch
    from repro_torch import zoo
    from repro_torch.configs.base import CURConfig, OptimizerConfig
    from repro_torch.core import calibrate, compress_model, fold_cur, heal
    from repro_torch.data.tokens import SyntheticLM
    from repro_torch.dist import tree_flatten
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.launch.serve import make_workload
    from repro_torch.models.layers import is_cur
    from repro_torch.optim.adamw import AdamW
    from repro_torch.serving import PagedConfig, Server
    from repro_torch.serving.speculative import early_exit_draft
    from repro_torch.train.evaluate import perplexity
    d = os.path.join(ROOT, "build", "chip_smoke_zoo")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    params, cfg = zoo.get_trained_repro(ZOO_STEPS, device="cuda", zoo_dir=d)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    shutil.rmtree(d)
    evalb = zoo.eval_batches(cfg, n=4, device="cuda")
    ppl0 = perplexity(params, cfg, evalb)
    ds = SyntheticLM(zoo.data_config(cfg, seed=1), "cuda")
    calib = calibrate(params, cfg, [ds.batch_at(i) for i in range(2)])
    sp, scfg, info = compress_model(params, cfg, CURConfig(
        r_max=64, n_compress_layers=3), calib)

    def folded(tree):             # every {C, U0, dU, R} as {CU, R}
        return {**tree, "groups": [
            [{k: fold_cur(w) if is_cur(w) else w for k, w in block.items()}
             for block in group] for group in tree["groups"]]}
    c0 = cm.launches
    ppl1 = perplexity(folded(sp), scfg, evalb)
    cur_launches = cm.launches - c0
    tr, fr = heal.partition_params(sp, heal.trainable_mask(sp, "dU"))
    opt = AdamW(OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=40))
    state = opt.init(tr)
    step = heal.make_heal_step(scfg, cfg, params, opt)
    hds = SyntheticLM(zoo.data_config(cfg, seed=2), "cuda")
    t1 = time.perf_counter()
    kd = []
    for i in range(40):
        tr, state, loss = step(tr, fr, state, hds.batch_at(i))
        kd.append(float(loss))
    t_heal = time.perf_counter() - t1
    ppl2 = perplexity(folded(heal.combine_params(tr, fr)), scfg, evalb)
    say(f"  9c trained REPRO ({cfg.name}, {ZOO_STEPS} zoo steps in "
        f"{t_train:.1f} s): perplexity trained {ppl0:.3f}, CURed "
        f"({len(info.layers)} layers {info.layers}, r_max 64, folded) "
        f"{ppl1:.3f}, healed "
        f"(40 dU-only KD steps in {t_heal:.1f} s, KD loss {kd[0]:.4f} -> "
        f"{kd[-1]:.4f}) {ppl2:.3f}; uniform would be {cfg.vocab_size}; "
        f"cur_matmul launches in the folded pass {cur_launches}")
    wl = make_workload(16, cfg.vocab_size, max_new=32)
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    pc = PagedConfig.sized_for(max_len, 8, block_size=16)
    off = _serve_all(Server(params, cfg, pc, max_concurrency=8,
                            device="cuda"), wl)
    dparams, dcfg = early_exit_draft(params, cfg, 2)
    srv = Server(params, cfg, pc, max_concurrency=8, draft_params=dparams,
                 draft_cfg=dcfg, spec_k=4, device="cuda")
    on = _serve_all(srv, wl)
    st = srv.stats()
    say(f"    served with draft self:2, spec_k 4 ({len(wl)} requests of "
        f"workload A): accept rate {st['spec_accept_rate']:.4f} over "
        f"{st['n_spec_windows']} windows ({st['n_spec_fallbacks']} "
        f"fallbacks); greedy tokens "
        f"{'identical to' if on == off else 'DIFFER from'} spec-off")
    checks = {
        "perplexities finite": all(math.isfinite(x)
                                   for x in (ppl0, ppl1, ppl2)),
        "trained perplexity below uniform": ppl0 < cfg.vocab_size,
        "3 layers CURed": len(info.layers) == 3,
        "cur_matmul launched by the folded passes": cur_launches > 0,
        "spec-on tokens == spec-off (f32)": on == off,
        "speculative windows ran": st["n_spec_windows"] > 0,
        "healed dU finite": all(bool(torch.isfinite(t).all())
                                for t in tree_flatten(tr)),
    }
    return [f"9c: {k}" for k, ok in checks.items()
            if not ok], (params, cfg)


def _sub_profile(prof, r_top):
    """``prof`` cut to the grid ranks <= r_top: DEIM's prefix consistency
    makes each cut curve the one a profile on the smaller grid gives."""
    import dataclasses
    curves = []
    for c in prof.curves:
        k = sum(1 for r in c.grid if r <= r_top)
        curves.append(dataclasses.replace(
            c, grid=c.grid[:k], rel_err=c.rel_err[:k],
            func_err=c.func_err[:k], bound=c.bound[:k]))
    return dataclasses.replace(
        prof, curves=curves, grid=tuple(r for r in prof.grid if r <= r_top))


def _histogram(ranks):
    out = {}
    for r in ranks.values():
        out[r] = out.get(r, 0) + 1
    return dict(sorted(out.items()))


def _by_rank(fn):
    """fn() with cur_matmul's launches tallied by rank (the kernel's own
    ``launches`` count is untouched). Returns (fn's result, tally)."""
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    real, tally = cm.cur_matmul, {}

    def tallied(x, cu, r, *a, **kw):
        n0 = cm.launches
        y = real(x, cu, r, *a, **kw)
        if cm.launches > n0:
            tally[cu.shape[1]] = tally.get(cu.shape[1], 0) + cm.launches - n0
        return y

    cm.cur_matmul = tallied
    try:
        out = fn()
    finally:
        cm.cur_matmul = real
    return out, dict(sorted(tally.items()))


def _class_seconds(fn):
    """fn() with the obs registry on: (fn's result, {"MxNrR": (weights,
    seconds per weight)} from repro_compress_class_s). The registry is off
    and empty again after."""
    from repro_torch import obs
    obs.default_registry().reset()
    obs.enable()
    try:
        out = fn()
        snap = obs.default_registry().snapshot()
    finally:
        obs.disable()
        obs.default_registry().reset()
    kids = snap.get("repro_compress_class_s", {}).get("children", {})
    return out, {k.split("=", 1)[1]: (v["count"], round(v["mean"], 4))
                 for k, v in kids.items()}


def _deim_seconds(shapes, r):
    """Seconds of one DEIM sweep at rank r over a (k, m, r) orthonormal
    stack, for each (k, m) in shapes."""
    import torch
    from repro_torch.core.deim import deim
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for k, m in shapes:
        V = torch.linalg.qr(torch.randn((k, m, r), generator=gen,
                                        device="cuda"))[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deim(V)
        torch.cuda.synchronize()
        out[f"({k}, {m}, {r})"] = round(time.perf_counter() - t0, 3)
    return out


def _prog_summary(res, seconds):
    return {"rounds": [{"round": r.round, "layers": r.layers,
                        "ranks": r.ranks, "accepted": r.accepted,
                        "ppl_compressed": r.ppl_compressed, "ppl": r.ppl}
                       for r in res.rounds],
            "early_stopped": res.early_stopped,
            "ppl_initial": res.ppl_initial, "ppl_final": res.ppl_final,
            "seconds": seconds}


def cpu_progressive(in_path, out_path):
    """Phase 10e's CPU run, in a process of its own (started after the
    card's run, so that it shares the host with no timed part):
    ``progressive_cure`` on the inputs saved at ``in_path``, its summary
    written to ``out_path`` as JSON."""
    import torch
    from repro_torch.configs.base import CURConfig
    from repro_torch.plan import progressive_cure
    torch.set_num_threads(6)
    d = torch.load(in_path, weights_only=False)
    t0 = time.perf_counter()
    res = progressive_cure(
        d["params"], d["cfg"], calib_batches=d["calib"],
        eval_batches=d["eval"], heal_batch_at=d["heal"].__getitem__,
        cur_cfg=CURConfig(r_max=64, fold_u=False), **PROG)
    with open(out_path, "w") as f:
        json.dump(_prog_summary(res, time.perf_counter() - t0), f)
    return 0


def _prog_inputs(zoo_model):
    """Phase 10e's inputs on the card: the trained model, 2 calibration
    batches, 2 eval batches and the heal stream (the plan CLI's --zoo
    batches), each made once so that the CPU run gets the same tokens."""
    from repro_torch import zoo
    from repro_torch.data.tokens import SyntheticLM
    params, cfg = zoo_model
    ds = SyntheticLM(zoo.data_config(cfg, seed=1), "cuda")
    heal = SyntheticLM(zoo.data_config(cfg, seed=2), "cuda")
    return {"params": params, "cfg": cfg,
            "calib": [ds.batch_at(i) for i in range(2)],
            "eval": zoo.eval_batches(cfg, n=2, device="cuda"),
            "heal": [heal.batch_at(i)
                     for i in range(PROG["rounds"] * PROG["heal_steps"])]}


def _start_cpu_progressive(inputs):
    """Save phase 10e's inputs on the host and start the CPU run."""
    import torch
    from repro_torch.bridge import tree_map
    cpu = {k: (tree_map(lambda t: t.cpu(), v) if k != "cfg" else v)
           for k, v in inputs.items()}
    src = os.path.join(PLAN_DIR, "prog_in.pt")
    out = os.path.join(PLAN_DIR, "prog_cpu.json")
    torch.save(cpu, src)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-progressive",
         src, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, out


def plan_full_width(run, ppl_uniform):
    """10a: ``plan_for_model`` on phase 6's llama3.1-8b (its params and
    calibration, its 10 layers) at the uniform allocation's deployed
    params, exact SVD, grid 4 .. 512 (on the default grid 4 .. 256 the
    uniform budget is the grid's top, so the plan is the uniform one);
    greedy and dp; the greedy plan executed and its folded perplexity."""
    import torch
    from repro_torch.configs.base import CURConfig
    from repro_torch.core import compress_model
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.plan import allocate, default_grid, plan_for_model
    from repro_torch.train.evaluate import perplexity
    rep = run.report
    budget = float(rep["params"]["after_deployed"])
    ccfg = CURConfig(r_max=PLAN_R_MAX, n_compress_layers=10, svd="exact",
                     fold_u=True, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    plan, prof = plan_for_model(
        run.params, run.cfg, ccfg, run.calib, budget_kind="params",
        budget_value=budget, n_layers=10, grid=default_grid(PLAN_R_MAX),
        solver="greedy", arch=run.cfg.name)
    t_plan = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    dp = allocate(prof, "params", budget, arch=run.cfg.name, solver="dp",
                  fold_u=True, dtype_bytes=2, seed=0)
    sub = _sub_profile(prof, 256)
    uni = allocate(sub, "params", budget, solver="greedy", fold_u=True,
                   dtype_bytes=2)
    per_class = {k: round(v, 3) for k, v in prof.class_seconds.items()}
    say(f"  10a plan_for_model llama3.1-8b, {len(prof.curves)} weights in "
        f"layers {plan.layers}, exact SVD, grid {list(prof.grid)}, budget "
        f"{int(budget)} params (the uniform r_max 256 allocation's, "
        f"fraction {rep['plan']['budget']['realized_fraction']}): "
        f"{t_plan:.3f} s (profile {prof.seconds:.3f} s; per class "
        f"{json.dumps(per_class)})"
        f"; peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB "
        f"held before)")
    for label, p in (("greedy", plan), ("dp", dp),
                     ("greedy on the 4 .. 256 grid", uni)):
        say(f"    {label}: allocate {p.predicted['solve_seconds']} s, "
            f"ranks {json.dumps(_histogram(p.ranks))}, realized "
            f"{p.realized['params_after']:.0f} params (fraction "
            f"{p.realized['fraction']}), objective "
            f"{p.predicted['objective']:.6g}, feasible {p.feasible}")
    say(f"    DEIM sweeps at r {PLAN_R_MAX} (s): "
        f"{json.dumps(_deim_seconds(((10, 4096), (10, 1024)), PLAN_R_MAX))}")
    t1 = time.perf_counter()
    (pparams, pcfg, pinfo), by_class = _class_seconds(
        lambda: compress_model(run.params, run.cfg,
                               plan.to_cur_config(CURConfig()), run.calib,
                               layers=plan.layers))
    torch.cuda.synchronize()
    t_exec = time.perf_counter() - t1
    gaps = {}
    for w in pinfo.weights:
        c = prof.curve(f"{w.layer}:{w.name}")
        gaps[c.key] = abs(float(c.rel_err[c.grid.index(w.rank)])
                          - w.fro_err / w.fro_w)
    worst = max(gaps, key=gaps.get)
    ds = SyntheticLM(DataConfig(run.cfg.vocab_size, 512, 4, seed=1), "cuda")
    evl = [ds.batch_at(1000 + i) for i in range(2)]
    ppl_plan, tally = _by_rank(lambda: perplexity(pparams, pcfg, evl))
    say(f"    greedy plan executed (compress_model, exact SVD): "
        f"{t_exec:.3f} s (weights, s per weight by class "
        f"{json.dumps(by_class)}); profiled vs executed rel_err over "
        f"{len(gaps)} weights: worst |gap| {gaps[worst]:.3e} ({worst})")
    say(f"    folded perplexity planned {ppl_plan:.6f} vs uniform "
        f"{ppl_uniform:.6f} (phase 6, randomized SVD); cur_matmul launches "
        f"by rank in that pass {json.dumps(tally)}")
    checks = {
        "30 planned weights": len(plan.ranks) == 30,
        "phase 6's layers": plan.layers == rep["layers_compressed"],
        "every executed rank the plan's": {
            f"{w.layer}:{w.name}": w.rank for w in pinfo.weights}
            == plan.ranks,
        "every profiled rel_err within 1e-4 of the executed":
            len(gaps) == 30 and gaps[worst] < 1e-4,
        "greedy and dp feasible": plan.feasible and dp.feasible,
        "the 4 .. 256 grid gives the uniform plan":
            set(uni.ranks.values()) == {256},
        "planned perplexity finite": math.isfinite(ppl_plan),
        "cur_matmul launched": sum(tally.values()) > 0,
    }
    del pparams
    return [f"10a: {k}" for k, ok in checks.items() if not ok], prof


def plan_latency(prof):
    """10b: a --budget-latency-ms allocation at the H100 roofline ms of
    the uniform r 256 allocation (folded, bf16), on 10a's profile."""
    from repro_torch.plan import allocate, weight_cost
    ms = sum(weight_cost(c.shape[0], c.shape[1], 256, "latency_ms",
                         fold_u=True, dtype_bytes=2) for c in prof.curves)
    bad = []
    for solver in ("greedy", "dp"):
        p = allocate(prof, "latency_ms", ms, solver=solver, fold_u=True,
                     dtype_bytes=2)
        got = p.realized["latency_ms_after"]
        say(f"  10b latency budget {ms:.6f} ms (H100 roofline, uniform r "
            f"256) {solver}: realized {got} ms, ranks "
            f"{json.dumps(_histogram(p.ranks))}, params fraction "
            f"{p.realized['params_after'] / p.realized['params_before']:.6f}"
            f", allocate {p.predicted['solve_seconds']} s")
        if not (p.feasible and got <= ms * (1 + 1e-6)):
            bad.append(f"10b: {solver} realized {got} > requested {ms}")
    return bad


def plan_draft(run, stats_a):
    """10c: cure --emit-draft's draft (``build_draft``) held in memory:
    --draft-budget-params 0.35 over all 30 interior layers (r_max 256,
    randomized SVD, cure's defaults); its deployed fraction of the
    target; served on phase 7's run-(a) workload at spec_k 4."""
    import torch
    from repro_torch.launch import cure as cure_mod
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serving import PagedConfig, Server
    args = cure_mod.parser().parse_args([
        "--arch", "llama3.1-8b", "--layers", "10", "--r-max", "256",
        "--emit-draft", "--draft-layers", str(DRAFT_LAYERS),
        "--draft-budget-params", "0.35", "--device", "cuda"])
    t0 = time.perf_counter()
    (dparams, dcfg, dplan, dinfo), by_class = _class_seconds(
        lambda: cure_mod.build_draft(run.params, run.cfg, run.calib, args))
    torch.cuda.synchronize()
    t_draft = time.perf_counter() - t0
    total = run.cfg.param_count()
    frac = (total - dinfo.params_saved) / total
    today = (total - run.report["params"]["saved_deployed"]) / total
    stats_a = stats_a or {"spec_accept_rate": float("nan"),
                          "tokens_per_s": float("nan"),
                          "tpot_p50_s": float("nan")}   # phase 7 not run
    say(f"  10c draft (build_draft, {len(dinfo.layers)} layers, "
        f"{len(dinfo.weights)} weights) in {t_draft:.3f} s: ranks "
        f"{json.dumps(_histogram(dplan.ranks))}, targeted fraction "
        f"{dplan.realized['fraction']} (budget 0.35), deployed "
        f"{total - dinfo.params_saved} of {total} params = {frac:.4f} of "
        f"the target (phase 6's CURed model as the draft: {today:.4f}); "
        f"its compress (randomized SVD) by class: weights, s per weight "
        f"{json.dumps(by_class)}")
    wl = _workloads(run.cfg.vocab_size)["B"]
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    pc = PagedConfig.sized_for(max_len, 8, block_size=16)
    srv = Server(run.params, run.cfg, pc, max_concurrency=8,
                 draft_params=dparams, draft_cfg=dcfg, spec_k=SPEC_K,
                 device="cuda")
    finished, st = run_continuous(srv, wl, verbose=False)
    torch.cuda.synchronize()
    say(f"    served (workload B, dense pool, original target, spec_k "
        f"{SPEC_K}): accept rate {st['spec_accept_rate']:.4f} over "
        f"{st['n_spec_windows']} windows, {st['tokens_per_s']:.1f} tok/s, "
        f"TPOT p50 {st['tpot_p50_s'] * 1e3:.2f} ms; run (a) (phase 7, "
        f"phase 6's CURed model as the draft): accept rate "
        f"{stats_a['spec_accept_rate']:.4f}, "
        f"{stats_a['tokens_per_s']:.1f} tok/s, TPOT p50 "
        f"{stats_a['tpot_p50_s'] * 1e3:.2f} ms")
    checks = {
        "30 draft layers": len(dinfo.layers) == DRAFT_LAYERS,
        "draft plan feasible at 0.35": dplan.feasible
        and dplan.realized["fraction"] <= 0.35,
        "draft below phase 6's CURed model": frac < today,
        "every request finished": len(finished) == len(wl),
        "speculative windows ran": st["n_spec_windows"] > 0,
    }
    del srv, dparams
    torch.cuda.empty_cache()
    return [f"10c: {k}" for k, ok in checks.items() if not ok]


def plan_clis():
    """10d: the plan CLI and cure --plan (with --emit-draft) at --smoke on
    the card, both with --obs and --trace."""
    from repro_torch import obs
    from repro_torch.launch import cure as cure_mod
    from repro_torch.launch import plan as plan_cli
    d = os.path.join(PLAN_DIR, "cli")
    path = os.path.join(d, "plan.json")
    smoke = ["--arch", "llama3.1-8b", "--smoke", "--layers", "1",
             "--calib-len", "16", "--device", "cuda", "--obs", "--trace"]
    try:
        plan = plan_cli.main(smoke + [
            "--budget-params", "0.4", "--out", path, "--obs-out",
            os.path.join(d, "obs_plan")])
        rep = cure_mod.main(smoke + [
            "--plan", path, "--emit-draft", "--ckpt-dir",
            os.path.join(d, "ck"), "--obs-out", os.path.join(d, "obs_cure")])
    finally:
        obs.disable()
        obs.default_registry().reset()
    with open(os.path.join(d, "obs_cure", "metrics.json")) as f:
        names = sorted(n for n in json.load(f) if n.startswith(
            "repro_compress_"))
    with open(os.path.join(d, "obs_cure", "trace.json")) as f:
        spans = [e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X"]
    say(f"  10d plan CLI -> cure --plan on the card: ranks "
        f"{json.dumps(plan.ranks)} -> {json.dumps(rep['plan']['ranks'])}; "
        f"metrics {names}; trace spans {spans}")
    checks = {
        "cure --plan gives the plan's ranks": rep["plan"]["ranks"]
        == plan.ranks,
        "the plan CLI wrote trace.json and metrics.json": all(
            os.path.exists(os.path.join(d, "obs_plan", f))
            for f in ("trace.json", "metrics.json")),
        "the repro_compress_* metrics": len(names) >= 6,
        "the stage spans": spans == ["init", "calibrate", "plan",
                                     "compress", "fold", "save", "draft",
                                     "generate"],
        "the draft saved": os.path.exists(os.path.join(
            d, "ck", "draft", "plan.json")),
    }
    return [f"10d: {k}" for k, ok in checks.items() if not ok]


def plan_progressive(inputs):
    """10e: ``progressive_cure`` on 9c's trained REPRO model (budget 0.3,
    3 layers, 2 rounds, 20 heal steps) on the card, then the CPU run on
    the same tokens in a process of its own."""
    import torch
    from repro_torch.configs.base import CURConfig
    from repro_torch.plan import progressive_cure
    t0 = time.perf_counter()
    res = progressive_cure(
        inputs["params"], inputs["cfg"], calib_batches=inputs["calib"],
        eval_batches=inputs["eval"], heal_batch_at=inputs["heal"].__getitem__,
        cur_cfg=CURConfig(r_max=64, fold_u=False), **PROG)
    torch.cuda.synchronize()
    card = _prog_summary(res, time.perf_counter() - t0)
    cpu_proc, cpu_out = _start_cpu_progressive(inputs)
    try:
        log, _ = cpu_proc.communicate(timeout=900)
    finally:
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait()
    if cpu_proc.returncode != 0:
        return [f"10e: the CPU run failed: {log[-2000:]}"]
    with open(cpu_out) as f:
        cpu = json.load(f)
    say(f"  10e progressive_cure ({inputs['cfg'].name}, budget "
        f"{PROG['budget_value']}, {PROG['n_layers']} layers, "
        f"{PROG['rounds']} rounds, {PROG['heal_steps']} heal steps): card "
        f"{card['seconds']:.3f} s, CPU {cpu['seconds']:.3f} s (6 threads, "
        f"after the card's run)")
    gaps = []
    for key in ("ppl_initial", "ppl_final"):
        gaps.append(abs(card[key] - cpu[key]) / cpu[key])
        say(f"    {key}: card {card[key]:.6f} CPU {cpu[key]:.6f} rel gap "
            f"{gaps[-1]:.3e}")
    for a, b in zip(card["rounds"], cpu["rounds"]):
        for key in ("ppl_compressed", "ppl"):
            gaps.append(abs(a[key] - b[key]) / b[key])
        say(f"    round {a['round']}: layers {a['layers']} / {b['layers']}, "
            f"ranks {json.dumps(a['ranks'])} / {json.dumps(b['ranks'])}, "
            f"accepted {a['accepted']} / {b['accepted']}; ppl compressed "
            f"{a['ppl_compressed']:.6f} / {b['ppl_compressed']:.6f}, healed "
            f"{a['ppl']:.6f} / {b['ppl']:.6f} (card / CPU)")
    strip = [{k: r[k] for k in ("round", "layers", "ranks", "accepted")}
             for r in card["rounds"]]
    checks = {
        "layers, ranks and accept flags card == CPU": strip == [
            {k: r[k] for k in ("round", "layers", "ranks", "accepted")}
            for r in cpu["rounds"]],
        "early stop card == CPU": card["early_stopped"]
        == cpu["early_stopped"],
        "rounds ran": len(card["rounds"]) > 0,
        f"perplexity gaps card vs CPU <= {PROG_GAP:g}": max(gaps)
        <= PROG_GAP,
    }
    return [f"10e: {k}" for k, ok in checks.items() if not ok]


def phase_plan(run, ppl_uniform, stats_a, zoo_model):
    """Phase 10: budget-driven planning on the card. Each part is driven
    with the counts set to 0 just before it and read just after; 10e's CPU
    run follows its card run in a process of its own."""
    import shutil
    import torch
    say("== phase 10: plan (sensitivity profile -> allocate -> plan "
        "execution, on the card)")
    shutil.rmtree(PLAN_DIR, ignore_errors=True)
    os.makedirs(PLAN_DIR)
    if zoo_model is None:              # phase 9 not run: train it here
        from repro_torch import zoo
        d = os.path.join(ROOT, "build", "chip_smoke_zoo")
        shutil.rmtree(d, ignore_errors=True)
        zoo_model = zoo.get_trained_repro(ZOO_STEPS, device="cuda",
                                          zoo_dir=d)
        shutil.rmtree(d)
    inputs = _prog_inputs(zoo_model)
    total = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    failed, prof = [], None
    try:
        for part in ("a", "b", "c", "d", "e"):
            torch.cuda.synchronize()
            _zero_counts()
            if part == "a":
                out, prof = plan_full_width(run, ppl_uniform)
            elif part == "b":
                out = plan_latency(prof)
            elif part == "c":
                out = plan_draft(run, stats_a)
            elif part == "d":
                out = plan_clis()
            else:
                out = plan_progressive(inputs)
            torch.cuda.synchronize()
            n = _counts()
            say(f"    10{part} launches {json.dumps(n)}")
            for k, v in n.items():
                total[k] += v
            failed += out
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(PLAN_DIR, ignore_errors=True)
    say(f"  phase 10 launches {json.dumps(total)}")
    if failed:
        raise SystemExit(f"plan checks failed: {failed}")
    return total


def phase_split(run, heal_case=None):
    """Device time by kernel, run last so that no profiler window precedes
    a timed phase: cur_matmul per weight (and by pass) and the
    torch.matmul chain, flash_attention and paged_attention and SDPA at
    the main shapes (phase 4's), by ``device_ms``; then
    one folded perplexity pass of phase 6's model, its wall time against
    its kernels' busy time and the kernels that took the most."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.train.evaluate import perplexity
    say("== phase 8: device time by kernel (bf16; device ms per call by "
        "CUDA events, the calls queued behind a spin kernel, median of 25; "
        "cur_matmul by pass from torch.profiler)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16

    def cur_line(label, M, m, r, n):
        x = _randn(gen, (M, m), bf16)
        cu = _randn(gen, (m, r), bf16, m ** -0.5)
        rr = _randn(gen, (r, n), bf16, r ** -0.5)
        dev = device_ms(lambda: cm.cur_matmul(x, cu, rr))
        parts = kernel_ms(lambda: cm.cur_matmul(x, cu, rr))
        lib = device_ms(lambda: torch.matmul(torch.matmul(x, cu), rr))
        say(f"  cur_matmul {label}: device {dev:.4f} ms; by pass "
            f"{_passes(parts)}; torch.matmul chain {lib:.4f} ms")

    for name, (m, r, n) in CUR_SHAPES.items():
        cur_line(name, CUR_M, m, r, n)
    B, H, K, S, d = FLASH_SHAPE
    q = _randn(gen, (B, H, S, d), bf16)
    k = _randn(gen, (B, K, S, d), bf16)
    v = _randn(gen, (B, K, S, d), bf16)
    scale = d ** -0.5
    dev = device_ms(lambda: fa.flash_attention(q, k, v, scale=scale))
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    say(f"  flash_attention B={B} H={H} K={K} S={S} d={d} causal: "
        f"{dev:.4f} ms; SDPA {lib:.4f} ms")
    B, K, G, bs, maxb = PAGED_SHAPE
    for r, ctxs in [(128, None), (KV_RANK, None), (128, RAGGED_CTX)]:
        args = _paged_inputs(gen, r, ctxs)
        dev = device_ms(lambda: pa.paged_attention(*args))
        lib = device_ms(_sdpa_on_gathered(*args))
        span = (f"ctx={maxb * bs - 1}" if ctxs is None else
                f"ctx={min(ctxs)}-{max(ctxs)} (ragged)")
        say(f"  paged_attention B={B} K={K} G={G} r={r} bs={bs} {span}: "
            f"{dev:.4f} ms; SDPA (gather excluded) {lib:.4f} ms")
    span = SPEC_K + 1
    for r in (128, KV_RANK):
        args = _paged_inputs(gen, r, RAGGED_CTX, span=span)
        dev = device_ms(lambda: pa.paged_attention(*args, q_span=span))
        lib = device_ms(_sdpa_on_gathered(*args, span))
        say(f"  paged_attention verify q_span={span} G'={span * G} r={r} "
            f"ctx={min(RAGGED_CTX)}-{max(RAGGED_CTX)}: {dev:.4f} ms; SDPA "
            f"(gather excluded) {lib:.4f} ms")
    for name, (m, r, n) in CUR_SHAPES.items():
        cur_line(f"verify {name} M={VERIFY_M}", VERIFY_M, m, r, n)
    for M in (CUR_M, VERIFY_M):
        for name, (m, _, n) in CUR_SHAPES.items():
            for r in PLAN_RANKS:
                cur_line(f"plan rank {name} M={M} r={r}", M, m, r, n)
    ds = SyntheticLM(DataConfig(run.cfg.vocab_size, 512, 4, seed=1), "cuda")
    evl = [ds.batch_at(1000 + i) for i in range(2)]
    perplexity(run.cured_params, run.cured_cfg, evl)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        perplexity(run.cured_params, run.cured_cfg, evl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    say(f"  folded perplexity pass (traced): wall {wall:.3f} s, kernels "
        f"busy {busy:.3f} s, device idle share {1 - busy / wall:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"    {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d} x {e.key[:90]}")
    profile_spec_window(run)
    profile_scope(run)
    profile_train()
    if heal_case is not None:
        profile_heal(heal_case)


def _trace_step(label, fn):
    """One call of ``fn`` (a step that ends in a host read) under
    torch.profiler: wall against kernels' busy time, and the kernels that
    took the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    say(f"  {label} (traced): wall {wall:.3f} s, kernels busy {busy:.3f} s, "
        f"device idle share {1 - busy / wall:.3f}, "
        f"{sum(e.count for e in rows)} kernel launches")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"    {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d} x {e.key[:90]}")


def profile_heal(heal_case):
    """One llama3.1-8b heal step of phase 9b (its student, optimizer state
    and first batch) under torch.profiler."""
    step, tr, fr, opt_state, batch = heal_case
    _trace_step("llama3.1-8b heal step (batch 2 x 512)",
                lambda: float(step(tr, fr, opt_state, batch)[2]))


def profile_train():
    """One olmo-1b train step of phase 9a's path (batch 8 x 128, after two
    untraced steps) under torch.profiler: wall against kernels' busy time,
    and the kernels that took the most."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import make_train_step
    cfg = get_config("olmo-1b")
    params = init_params(0, cfg, "cuda")
    opt = AdamW(OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=8))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 128, 8), "cuda")
    for i in range(2):
        params, state, _ = step(params, state, ds.batch_at(i))
    batch = ds.batch_at(2)
    _trace_step("olmo-1b train step (batch 8 x 128)",
                lambda: float(step(params, state, batch)[2]))
    del params, state
    torch.cuda.empty_cache()


def profile_scope(run):
    """serve --prof's capture: one ``TorchProfiler.scope`` around one
    decode window of the CURed model (8 slots of workload B, dense pool).
    The Chrome trace it writes must name paged_attention's kernel
    (``paged_split_kernel``), and the tracer must hold the ``prof:decode``
    start and stop events with the card's memory snapshot."""
    import shutil
    from repro_torch.obs import TorchProfiler, Tracer
    from repro_torch.serving import PagedConfig, Server
    reqs = _workloads(run.cfg.vocab_size)["B"][:8]
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in reqs)
    srv = Server(run.cured_params, run.cured_cfg,
                 PagedConfig.sized_for(max_len, 8, block_size=16),
                 max_concurrency=8, device="cuda")
    for w in reqs:
        srv.submit(w["prompt"], w["max_new_tokens"])
    srv.step()                                  # the prefill of all 8
    out = os.path.join(ROOT, "build", "chip_smoke_torchprof")
    shutil.rmtree(out, ignore_errors=True)
    tracer = Tracer()
    prof = TorchProfiler(out, tracer=tracer)
    steps0 = srv.n_decode_steps
    with prof.scope("decode"):
        srv.step()
    steps = srv.n_decode_steps - steps0
    del srv
    kernels = {}
    for path in prof.paths:
        with open(path) as f:
            for e in json.load(f)["traceEvents"]:
                if e.get("cat") == "kernel":
                    kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    paged = sum(n for k, n in kernels.items() if "paged_split_kernel" in k)
    evs = [(e["name"], e["attrs"].get("phase"),
            e["attrs"].get("mem", {}).get("cuda:0", {}).get(
                "allocated_bytes.all.current", 0)) for e in tracer.events]
    say(f"  TorchProfiler.scope('decode') around one decode window "
        f"({steps} steps): {len(prof.paths)} trace file(s) "
        f"{[os.path.relpath(p, ROOT) for p in prof.paths]}, "
        f"{sum(kernels.values())} kernel events, paged_split_kernel "
        f"(paged_attention) {paged}; tracer events "
        f"{[(n, ph) for n, ph, _ in evs]}, allocated bytes at start / "
        f"stop {[m for _, _, m in evs]}")
    shutil.rmtree(out)
    ok = (len(prof.paths) == 1 and paged > 0
          and [(n, ph) for n, ph, _ in evs] == [("prof:decode", "start"),
                                               ("prof:decode", "stop")]
          and all(m > 0 for _, _, m in evs))
    if not ok:
        raise SystemExit("profiler capture check failed")


def _kernel_rows(prof):
    """The profiler's device kernels (the aten ops above them carry the
    same device time)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.self_device_time_total > 0]


def profile_spec_window(run):
    """One speculative window of phase 7's run (a) (original model, CURed
    draft, spec_k 4, 8 slots of workload B, dense pool) by part: the draft
    (k + 1 decode steps of the draft model) and the verify (one target
    forward over 5 positions) each under its own torch.profiler window, so
    that each part's device time, and paged_attention's at q_span 1 and
    q_span 5, read apart. Then one more window, untraced, under
    torch.cuda's sync debug mode: the number of host syncs in a window."""
    import traceback
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import PagedConfig, Server
    from repro_torch.serving import speculative
    reqs = _workloads(run.cfg.vocab_size)["B"][:8]
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in reqs)
    pc = PagedConfig.sized_for(max_len, 8, block_size=16)
    srv = Server(run.params, run.cfg, pc, max_concurrency=8,
                 draft_params=run.cured_params, draft_cfg=run.cured_cfg,
                 spec_k=SPEC_K, device="cuda")
    for w in reqs:
        srv.submit(w["prompt"], w["max_new_tokens"])
    srv.step()                                  # the prefill of all 8
    srv.step()                                  # a window, untraced
    torch.cuda.synchronize()
    parts = {}
    real = {"draft": speculative.draft_tokens,
            "verify": speculative.verify_tokens}

    def traced(name):
        def fn(*a, **kw):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = real[name](*a, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            parts[name] = (_kernel_rows(prof), wall)
            return out
        return fn

    speculative.draft_tokens = traced("draft")
    speculative.verify_tokens = traced("verify")
    try:
        ctx = srv.scheduler.ctx_lens()
        srv.step()
    finally:
        speculative.draft_tokens = real["draft"]
        speculative.verify_tokens = real["verify"]
    for name in ("draft", "verify"):
        rows, wall = parts[name]
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        paged = [e for e in rows if "paged" in e.key]
        p_ms = sum(e.self_device_time_total for e in paged) / 1e3
        p_n = sum(e.count for e in paged)
        say(f"  spec window (a), 8 slots at ctx {int(ctx.min())}-"
            f"{int(ctx.max())}, {name}: wall {wall * 1e3:.1f} ms (traced), "
            f"kernels busy {busy:.3f} ms, device idle share "
            f"{1 - busy / 1e3 / wall:.3f}; paged_attention "
            f"{'q_span 1' if name == 'draft' else f'q_span {SPEC_K + 1}'}"
            f" {p_n} launches, {p_ms:.3f} ms "
            f"({1e3 * p_ms / max(p_n, 1):.2f} us per launch)")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:5]:
            say(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:6d} x {e.key[:80]}")
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    syncs = []

    def where(message, category, filename, lineno, file=None, line=None):
        # the innermost frames of this repository at the synchronizing op
        if "synchroniz" in str(message):
            syncs.append(" < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}"
                for f in reversed(traceback.extract_stack()[:-1])
                if "repro_torch" in f.filename)[:120])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = where
        torch.cuda.set_sync_debug_mode("warn")
        try:
            srv.step()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    say(f"  spec window (a), untraced: {len(syncs)} host syncs "
        f"(torch.cuda sync debug mode):")
    for site in sorted(set(syncs)):
        say(f"    {syncs.count(site)} x {site}")
    del srv
    torch.cuda.empty_cache()


def profile_decode(params, cfg, wl):
    """Where a decode window's time goes: one 16-step window of 8 slots at
    workload B's prompts (dense pool) timed alone, then the next one under
    torch.profiler. Prints the windows' step counts and wall times, the
    device's busy time per window and per step and its idle share (kernel
    time over traced wall time), paged_attention's launches and device
    time per window and per step, and the kernels that took the most
    device time in the window. A measurement, not a check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import PagedConfig, Server
    reqs = wl[:8]
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in reqs)
    pc = PagedConfig.sized_for(max_len, 8, block_size=16)
    srv = Server(params, cfg, pc, max_concurrency=8, device="cuda")
    for w in reqs:
        srv.submit(w["prompt"], w["max_new_tokens"])
    srv.step()                                  # the prefill of all 8
    torch.cuda.synchronize()
    steps0 = srv.n_decode_steps
    t0 = time.perf_counter()
    srv.step()                                  # a decode window, untraced
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_steps = srv.n_decode_steps - steps0
    ctx = srv.scheduler.ctx_lens()
    steps0 = srv.n_decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = srv.n_decode_steps - steps0
    # kernels only (the aten ops above them carry the same device time)
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    paged = [e for e in rows if "paged" in e.key]
    paged_us = sum(e.self_device_time_total for e in paged)
    paged_n = sum(e.count for e in paged)
    say(f"  decode window untraced: {plain_steps} steps, wall "
        f"{plain_wall * 1e3:.1f} ms ({plain_wall * 1e3 / plain_steps:.2f} "
        f"ms/step)")
    say(f"  profile: the next window, {steps} steps, 8 slots at ctx "
        f"{int(ctx.min())}-{int(ctx.max())}: wall {wall * 1e3:.1f} ms "
        f"({wall * 1e3 / steps:.2f} ms/step, traced), kernels busy "
        f"{busy_us / 1e3:.3f} ms per window, {busy_us / 1e3 / steps:.3f} ms "
        f"per step, device idle share {1 - busy_us / 1e6 / wall:.3f}")
    say(f"  profile: paged_attention {paged_n} launches in the window "
        f"({paged_n / steps:g} per step), {paged_us / 1e3:.3f} ms per "
        f"window, {paged_us / 1e3 / steps:.3f} ms per step, "
        f"{paged_us / max(paged_n, 1):.2f} us per launch")
    if not rows:
        say("  profile: the profiler saw no device time")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"    {e.self_device_time_total / 1e3:9.3f} ms per window "
            f"{e.count:6d} x {e.key[:80]}")
    del srv
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: the other families (MoE, Mamba-2, hybrid, head dim 256)
# ---------------------------------------------------------------------------

FAMILY_SMOKES = ("jamba-v0.1-52b", "mixtral-8x22b", "kimi-k2-1t-a32b",
                 "mamba2-1.3b", "gemma3-1b")
# phase 11's checkpoints (git-ignored; deleted after each run)
FAMILY_DIR = os.path.join(ROOT, "build", "chip_smoke_family")
JAMBA_PERIODS = 1                             # 8 of 32 layers
JAMBA_PARAMS = 13_267_540_608                 # one period at full width
MIXTRAL_LAYERS = 4                            # of 56
MIXTRAL_PARAMS = 10_418_903_040
MIXTRAL_PROMPTS = (4160, 4352, 4480, 4608)    # cross the 4096 window
GEMMA_PROMPT = 700                            # past the 512 window
DEVICES = {"card": "cuda", "cpu": "cpu"}      # 11a's two runs


class _CpuMade:
    """cure_run's init and calibration data made on the CPU and copied to
    ``device``: the same params and tokens on the card and the CPU."""

    def __init__(self, cure_mod, params_cpu):
        self.mod, self.params = cure_mod, params_cpu

    def __enter__(self):
        from repro_torch.data.tokens import SyntheticLM
        from repro_torch.bridge import tree_map
        params = self.params

        def init(seed, cfg, device):
            return tree_map(lambda t: t.to(device), params)

        class Data:
            def __init__(self, dc, device):
                self.ds, self.device = SyntheticLM(dc, "cpu"), device

            def batch_at(self, i):
                return {k: v.to(self.device)
                        for k, v in self.ds.batch_at(i).items()}

        self.saved = (self.mod.init_params, self.mod.SyntheticLM)
        self.mod.init_params, self.mod.SyntheticLM = init, Data
        return self

    def __exit__(self, *exc):
        self.mod.init_params, self.mod.SyntheticLM = self.saved


def _cure_args(arch, layers, r_max, *extra):
    from repro_torch.launch import cure as cure_mod
    return cure_mod.parser().parse_args(
        ["--arch", arch, "--layers", str(layers), "--r-max", str(r_max)]
        + list(extra) + ["--ckpt-dir", FAMILY_DIR])


def _indices(info):
    return [(w.layer, w.name, w.rank, w.rows.tolist(), w.cols.tolist())
            for w in info.weights]


def family_smokes():
    """11a: the SMOKE configs of the new families, f32, params from one
    seed made on the CPU: forward logits card vs CPU (2e-5); cure_run at
    --layers 2 --svd exact on both (the same layers and DEIM indices);
    the greedy tokens of the static engine (jamba, mamba2) or the Server
    (the attention stacks) on the CURed model, card == CPU."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_smoke
    from repro_torch.launch import cure as cure_mod
    from repro_torch.models import forward, init_params
    from repro_torch.serve import engine
    from repro_torch.serving import PagedConfig, Server
    from repro_torch.serving import paged_cache as pcache
    failed = []
    for arch in FAMILY_SMOKES:
        cfg = get_smoke(arch)
        p_cpu = init_params(0, cfg, "cpu")
        p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
        toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 40))
        t_cpu = torch.from_numpy(toks)
        rel = rel_err(forward(p_gpu, cfg, {"tokens": t_cpu.cuda()}).cpu(),
                      forward(p_cpu, cfg, {"tokens": t_cpu}))
        runs = {}
        for where, dev in DEVICES.items():
            shutil.rmtree(FAMILY_DIR, ignore_errors=True)
            args = _cure_args(arch, 2, 8, "--smoke", "--svd", "exact",
                              "--device", dev)
            with _CpuMade(cure_mod, p_cpu):
                runs[where] = cure_mod.cure_run(args)
        shutil.rmtree(FAMILY_DIR, ignore_errors=True)
        same_sel = (runs["card"].report["layers_compressed"]
                    == runs["cpu"].report["layers_compressed"]
                    and _indices(runs["card"].info)
                    == _indices(runs["cpu"].info))
        cp = {w: r.cured_params for w, r in runs.items()}
        ccfg = runs["cpu"].cured_cfg
        prompts = np.random.RandomState(4).randint(0, cfg.vocab_size, (3, 12))
        if pcache.supports(ccfg):
            via, out = "Server", {}
            for where, dev in DEVICES.items():
                srv = Server(cp[where], ccfg, PagedConfig.sized_for(
                    12 + 10, 3, block_size=4), max_concurrency=3,
                    device=dev)
                for row in prompts.tolist():
                    srv.submit(row, 10)
                srv.drain()
                out[where] = [srv.finished[i].out_tokens for i in range(3)]
        else:
            via = "engine"
            out = {where: engine.generate(cp[where], ccfg, torch.from_numpy(
                prompts).to(dev), 10).tokens.cpu().tolist()
                for where, dev in DEVICES.items()}
        ok = rel < F32_TOL and same_sel and out["card"] == out["cpu"]
        say(f"  11a {arch} (SMOKE, f32): forward card vs CPU rel {rel:.3e} "
            f"(tol {F32_TOL:g}); cure layers "
            f"{runs['card'].report['layers_compressed']} / "
            f"{runs['cpu'].report['layers_compressed']}, "
            f"{len(runs['card'].info.weights)} weights, DEIM indices "
            f"{'equal' if same_sel else 'DIFFER'}; {via} greedy tokens "
            f"card == CPU {out['card'] == out['cpu']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"11a {arch}")
        del runs, cp, p_gpu
        torch.cuda.empty_cache()
    return failed


def _deployed_saving(cfg, layers, r_max):
    """saved_deployed from the shapes: per compressed layer, each 2-D CUR
    target of its block at the rank cure gives it, m n - r (m + n)."""
    from repro_torch.core.cur import rank_for
    D, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"wq": (D, cfg.n_heads * hd), "wk": (D, cfg.n_kv_heads * hd),
              "w_gate": (D, cfg.d_ff), "w_x": (D, cfg.d_inner)}
    blocks = cfg.blocks
    total = 0
    for li in layers:
        spec = blocks[li]
        have = ({"wq", "wk"} if spec.mixer in ("attn", "attn_local") else
                {"w_x"}) | ({"w_gate"} if spec.mlp == "mlp" else set())
        for t in cfg.cur_targets:
            if t in have:
                m, n = shapes[t]
                r = rank_for(m, n, r_max)
                total += m * n - r * (m + n)
    return total


def _to_f32(tree):
    """Cast every floating leaf of a param tree to f32 in place, one leaf
    at a time (each bf16 leaf is freed as its f32 copy replaces it, when
    nothing else holds it)."""
    import torch
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            _to_f32(v)
        elif torch.is_tensor(v) and v.is_floating_point():
            tree[k] = v.float()
    return tree


class _RouteTape:
    """Holds decode's MoE routing against the forward's, by wrapping
    ``repro_torch.models.moe.route``. The caller marks each pass over the
    sequences: ``at(start, n)`` before a prefill or decode step over
    positions [start, start + n), ``at(None, S)`` before the forward over
    all S positions, whose calls are recorded (one (B, S, k) tensor of
    experts per MoE layer, in call order). Without ``force`` the passes
    keep their own routing; with it each pass routes its tokens to the
    forward's experts at the same layer and position, the gates taken
    from the pass's own probabilities there and renormalised as ``route``
    does. ``flips()`` counts, per pass, the tokens whose own expert set
    differs from the forward's, summed over the layers."""

    def __init__(self, force=False, rec=None):
        import repro_torch.models.moe as moe
        self.moe, self.real, self.force = moe, moe.route, force
        self.rec = [] if rec is None else rec
        self.passes, self.span = [], None

    def __enter__(self):
        self.moe.route = self._route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real

    def at(self, start, n):
        self.span = (start, n)
        if start is not None:
            self.passes.append((start, n, []))
        elif not self.force:
            self.rec.clear()

    def _route(self, xt, router, k):
        import torch
        gates, experts = self.real(xt, router, k)
        start, n = self.span
        if start is None:
            if not self.force:
                self.rec.append(experts.reshape(-1, n, k))
            return gates, experts
        calls = self.passes[-1][2]
        calls.append(experts)
        if not self.force:
            return gates, experts
        want = self.rec[len(calls) - 1][:, start:start + n].reshape(-1, k)
        probs = torch.softmax((xt @ router.to(xt.dtype)).float(), dim=-1)
        g = probs.gather(1, want)
        return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want

    def flips(self):
        """[(first position routed otherwise than the forward or None,
        tokens so routed summed over the layers)], one per pass."""
        import torch
        out = []
        for start, n, calls in self.passes:
            if len(calls) != len(self.rec):
                raise RuntimeError(f"pass at {start}: {len(calls)} MoE "
                                   f"calls, the forward made {len(self.rec)}")
            d = torch.zeros((self.rec[0].shape[0], n), dtype=torch.bool,
                            device=self.rec[0].device)
            count = 0
            for own, want in zip(calls, self.rec):
                want = want[:, start:start + n]
                diff = (own.reshape(want.shape).sort(-1)[0]
                        != want.sort(-1)[0]).any(-1)
                count += int(diff.sum())
                d |= diff
            hit = d.any(0).nonzero()
            out.append((start + int(hit[0]) if len(hit) else None, count))
        return out


def _engine_vs_forward(params, cfg, B, S, n_new, label, tape=None):
    """The static engine's greedy generate(): prefill and decode logits at
    ENGINE_CHECK_STEPS against forward() over the grown sequence, each
    pass marked on ``tape`` when given. Returns ({step: rel}, decode ms
    per step, the grown sequence, forward()'s logits)."""
    import torch
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.models import forward
    from repro_torch.serve import engine
    prompts = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=2),
                          "cuda").batch_at(0)["tokens"]
    rec, steps = {}, [0]
    real_prefill, real_decode = engine.prefill, engine.decode_step
    mark = tape.at if tape is not None else (lambda start, n: None)

    def prefill(prm, c, batch, cache, mesh=None):
        mark(0, S)
        out = real_prefill(prm, c, batch, cache, mesh)
        rec[0] = out[0].clone()
        torch.cuda.synchronize()
        rec["t0"] = time.perf_counter()
        return out

    def decode_step(prm, c, batch, cache, pos, mesh=None):
        steps[0] += 1
        mark(S - 1 + steps[0], 1)
        out = real_decode(prm, c, batch, cache, pos, mesh)
        if steps[0] in ENGINE_CHECK_STEPS:
            rec[steps[0]] = out[0].clone()
        return out

    engine.prefill, engine.decode_step = prefill, decode_step
    try:
        out = engine.generate(params, cfg, prompts, n_new)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - rec.pop("t0")) * 1e3 / steps[0]
    finally:
        engine.prefill, engine.decode_step = real_prefill, real_decode
    seq = torch.cat([prompts, out.tokens[:, :n_new - 1]], dim=1)
    mark(None, seq.shape[1])
    full = forward(params, cfg, {"tokens": seq})
    rels = {t: rel_err(lg, full[:, S - 1 + t]) for t, lg in sorted(
        rec.items())}
    say(f"  {label} engine: B={B} prompts of {S}, {n_new} new (greedy), "
        f"decode {decode_ms:.2f} ms per step; logits vs forward() "
        + ", ".join(f"step {t} rel {r:.3e}" for t, r in rels.items())
        + f" (tol {BF16_TOL:g})")
    return rels, decode_ms, seq, full


def _engine_routed(params, cfg, seq, S, full, tape, label):
    """The engine's prefill and decode steps (models.prefill /
    decode_step, its cache and positions) teacher-forced on ``seq``, each
    pass routed by ``tape``: logits at ENGINE_CHECK_STEPS against
    ``full``, forward()'s logits over ``seq``. Returns {step: rel}."""
    import torch
    from repro_torch.models import decode_step, init_cache, prefill
    B = seq.shape[0]
    steps = max(ENGINE_CHECK_STEPS)
    cache = init_cache(cfg, B, S + steps + 1, "cuda")
    tape.at(0, S)
    logits, cache = prefill(params, cfg, {"tokens": seq[:, :S]}, cache)
    rels = {0: rel_err(logits, full[:, S - 1])}
    for i in range(1, steps + 1):
        p = S - 1 + i
        tape.at(p, 1)
        logits, cache = decode_step(
            params, cfg, {"tokens": seq[:, p:p + 1]}, cache,
            torch.full((B, 1), p, dtype=torch.int32, device="cuda"))
        if i in ENGINE_CHECK_STEPS:
            rels[i] = rel_err(logits, full[:, p])
    say(f"  {label}: logits vs forward() " + ", ".join(
        f"step {t} rel {r:.3e}" for t, r in rels.items())
        + f" (tol {BF16_TOL:g})")
    del cache
    return rels


def _flip_witness(rels, flips, S, label):
    """Whether every step whose logits depart from forward() past the bf16
    bound comes at or after a position whose token some pass routed
    otherwise than the forward did (a top-k flip upstream of it). Step t
    is position S - 1 + t. Prints the flips."""
    hits = [(p, d) for p, d in flips if p is not None]
    first = min((p for p, _ in hits), default=None)
    past = [t for t, r in rels.items() if r >= BF16_TOL]
    ok = all(first is not None and S - 1 + t >= first for t in past)
    say(f"  {label}: top-k flips against the forward's routing (first "
        f"position: tokens) " + (", ".join(f"{p}: {d}" for p, d in hits)
                                 or "none")
        + f"; steps past {BF16_TOL:g} {past}, each at or after the first "
        f"flip {ok}")
    return ok


def _paged_vs_forward(params, cfg, prompt, n_dec, label, tape=None,
                      seq=None):
    """One request through the paged runtime (runtime.paged_prefill, then
    n_dec runtime.paged_decode steps, on a dense pool): its logits against
    forward() over the grown sequence. The decode tokens are greedy, or
    ``seq``'s (teacher-forced); each pass is marked on ``tape`` when
    given. Returns (the logits' rels, prefill first, and the sequence)."""
    import torch
    from repro_torch.models import forward
    from repro_torch.serving import PagedConfig, runtime
    from repro_torch.serving import paged_cache as pcache
    n = len(prompt)
    mark = tape.at if tape is not None else (lambda start, k: None)
    pc = PagedConfig.sized_for(n + n_dec, 1, block_size=16)
    cache = pcache.init_paged_cache(cfg, pc, "cuda")
    table = torch.full((1, pc.max_blocks_per_seq), -1, dtype=torch.int32)
    nblk = pc.blocks_for(n + n_dec)
    table[0, :nblk] = torch.arange(nblk, dtype=torch.int32)
    mark(0, n)
    logits, cache = runtime.paged_prefill(
        params, cfg, pc, torch.tensor([prompt]), torch.tensor([n]), cache,
        table)
    got, out = [logits[0]], list(prompt)
    active = torch.ones((1,), dtype=torch.bool)
    for i in range(n_dec):
        out.append(int(got[-1].argmax()) if seq is None else seq[n + i])
        mark(n + i, 1)
        logits, cache = runtime.paged_decode(
            params, cfg, pc, torch.tensor([[out[-1]]]), cache, table,
            torch.tensor([n + i], dtype=torch.int32), active)
        got.append(logits[0])
    mark(None, len(out))
    full = forward(params, cfg, {"tokens": torch.tensor([out],
                                                        device="cuda")})[0]
    rels = [rel_err(g, full[n - 1 + i]) for i, g in enumerate(got)]
    say(f"  {label} paged runtime, one request of {n} tokens + {n_dec} "
        f"decodes (dense pool, r {cfg.resolved_head_dim}): logits vs "
        f"forward() prefill rel {rels[0]:.3e}, decode "
        + ", ".join(f"{r:.3e}" for r in rels[1:]) + f" (tol {BF16_TOL:g})")
    del cache, full
    return rels, out


def _kind_trace(params, cfg, batch, mesh=None):
    """Device time of one forward by layer kind, from torch.profiler's
    record_function scopes around each kind's function (inclusive:
    mamba_block holds its ssd_scan and its cur_matmul; moe_forward is
    moe_dense without a mesh)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    import repro_torch.kernels.cur_matmul.ops as cm_ops
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.mamba as mb_mod
    import repro_torch.models.model as model_mod
    from repro_torch.models import forward
    scopes = [(model_mod, "moe_forward", "moe_forward"),
              (model_mod, "mlp_forward", "mlp"),
              (mb_mod, "mamba_forward", "mamba_block"),
              (mb_mod, "ssd_chunked", "ssd_scan"),
              (attn_mod, "attn_forward", "attention"),
              (cm_ops, "cur_matmul_op", "cur_matmul")]
    saved = []
    for mod, fn, name in scopes:
        real = getattr(mod, fn)

        def wrapped(*a, _real=real, _name=name, **kw):
            with record_function(_name):
                return _real(*a, **kw)
        saved.append((mod, fn, real))
        setattr(mod, fn, wrapped)
    try:
        with torch.no_grad():
            forward(params, cfg, batch, mesh)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                forward(params, cfg, batch, mesh)
                torch.cuda.synchronize()
    finally:
        for mod, fn, real in saved:
            setattr(mod, fn, real)
    names = {name for _, _, name in scopes}
    kind, busy = {}, 0.0
    # the hand kernels are launched through ctypes: their device time is
    # summed by kernel name as well as under the scopes
    by_name = {"cur_matmul kernels": ("pass1_kernel", "reduce_kernel",
                                      "pass2_kernel", "cur_matmul_kernel"),
               "flash_attention kernels": ("flash_kernel",)}
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            for label, keys in by_name.items():
                if any(k in e.key for k in keys):
                    kind[label] = kind.get(label, 0.0) + getattr(
                        e, "self_device_time_total", 0.0) / 1e3
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        if e.key in names and getattr(e, "device_type", None) is not None \
                and "CPU" in str(e.device_type):
            kind[e.key] = dev / 1e3
        if "CUDA" in str(getattr(e, "device_type", "")) and \
                e.key not in names:
            busy += getattr(e, "self_device_time_total", 0.0) / 1e3
    # the profiler's context manager and this frame refer to each other:
    # drop it, or the cycle keeps params (the whole model) alive until the
    # garbage collector runs
    del prof
    return kind, busy


def family_jamba():
    """11b: jamba-v0.1-52b at full width, one period (8 of 32 layers),
    bf16, random weights from seed 0 made on the card: cure_run at
    --layers 6, r_max 256 on 4 x 4 x 512 calibration tokens; the save and
    the engine's generate stage; saved_deployed against the count from
    the shapes; original and folded perplexity and the folded pass's
    time; engine decode logits against forward(); a device trace of one
    folded forward by layer kind."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs import jamba_v0_1_52b as jamba
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.launch import cure as cure_mod
    from repro_torch.train.evaluate import perplexity
    full = get_config("jamba-v0.1-52b")
    cfg = full.replace(n_layers=8 * JAMBA_PERIODS,
                       groups=((jamba._PERIOD, JAMBA_PERIODS),))
    failed = []
    real_get = cure_mod.get_config
    cure_mod.get_config = lambda name: cfg
    shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        run = cure_mod.cure_run(_cure_args(
            "jamba-v0.1-52b", 6, 256, "--calib-batches", "4",
            "--calib-batch", "4", "--calib-len", "512", "--device", "cuda"))
    finally:
        cure_mod.get_config = real_get
    ckpt = _dir_bytes(FAMILY_DIR)
    shutil.rmtree(FAMILY_DIR)
    rep = run.report
    want = _deployed_saving(cfg, rep["layers_compressed"], 256)
    names = sorted({w["name"] for w in rep["weights"]})
    say(f"  11b jamba-v0.1-52b: {JAMBA_PERIODS} period ({cfg.n_layers} of "
        f"{full.n_layers} layers), d {cfg.d_model}, {cfg.param_count()} "
        f"params ({cfg.param_count() * 2 / 1e9:.1f} GB bf16); stages_s "
        f"{json.dumps(rep['stages_s'])}; checkpoint {ckpt} bytes (deleted)")
    say(f"    layers {rep['layers_compressed']}, {rep['n_weights']} weights "
        f"{names}; saved_deployed {rep['params']['saved_deployed']} (from "
        f"the shapes {want}); generate {rep['generate']['tokens']} tokens "
        f"via {rep['generate']['engine']}")
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 512, 4, seed=1), "cuda")
    evl = [ds.batch_at(1000 + i) for i in range(2)]
    ppl_orig = perplexity(run.params, cfg, evl)
    c0 = _counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ppl_cur = perplexity(run.cured_params, run.cured_cfg, evl)
    torch.cuda.synchronize()
    t_fold = time.perf_counter() - t1
    fold = {k: v - c0[k] for k, v in _counts().items()}
    say(f"    perplexity original {ppl_orig:.6f} folded {ppl_cur:.6f} "
        f"(2 x 4 x 512 tokens); folded pass {t_fold:.3f} s, launches "
        f"{json.dumps(fold)}")
    # bf16, printed: the engine's own routing, its top-k flips against
    # the forward's, then the same tokens routed as the forward routes
    # them (the recurrent decode's own rounding stays: the CPU test
    # test_bf16_decode_gap_within_the_reference_gap holds that part to
    # the JAX package's gap)
    tape = _RouteTape()
    with tape:
        bf_rels, _, seq, full = _engine_vs_forward(
            run.cured_params, run.cured_cfg, 2, 256, 64,
            "    jamba folded, bf16, own routing (printed)", tape)
    _flip_witness(bf_rels, tape.flips(), 256, "    jamba bf16")
    with _RouteTape(force=True, rec=tape.rec) as held:
        _engine_routed(run.cured_params, run.cured_cfg, seq, 256, full, held,
                       "    jamba folded, bf16, the forward's routing "
                       "(printed)")
    del tape, held, full
    kind, busy = _kind_trace(run.cured_params, run.cured_cfg, evl[0])
    say(f"    trace of one folded forward (4 x 512 tokens), device ms by "
        f"layer kind (inclusive): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(kind.items()))
        + f"; kernels busy {busy:.3f} ms")
    # the cache-state check in f32, where neither rounding nor a top-k
    # flip hides a state that was not carried
    cured, ccfg = run.cured_params, run.cured_cfg.replace(dtype="float32")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    rels = _engine_vs_forward(_to_f32(cured), ccfg, 2, 256, 64,
                              "    jamba folded, f32")[0]
    say(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; wall {time.perf_counter() - t0:.1f} s")
    checks = {
        "13,267,540,608 params": cfg.param_count() == JAMBA_PARAMS,
        "6 layers, wq wk w_gate w_x": len(rep["layers_compressed"]) == 6
            and names == ["w_gate", "w_x", "wk", "wq"],
        "saved_deployed from the shapes":
            rep["params"]["saved_deployed"] == want,
        "generate via the engine": rep["generate"]["engine"] == "legacy",
        "finite perplexities":
            math.isfinite(ppl_orig) and math.isfinite(ppl_cur),
        "cur_matmul and flash_attention on the folded pass":
            fold["cur_matmul"] > 0 and fold["flash_attention"] > 0,
        "f32 engine logits within 2e-2": max(rels.values()) < BF16_TOL,
    }
    failed += [f"11b {k}" for k, ok in checks.items() if not ok]
    del cured
    torch.cuda.empty_cache()
    return failed


def _serve_long(params, cfg, prompts, n_new, label):
    """The Server (dense pool, block 16) on long prompts at once; counts
    the blocks the scheduler evicts behind the window."""
    import torch
    from repro_torch.serving import PagedConfig, Server
    B = len(prompts)
    max_len = max(len(p) for p in prompts) + n_new
    srv = Server(params, cfg, PagedConfig.sized_for(max_len, B,
                                                    block_size=16),
                 max_concurrency=B, device="cuda")
    evicted = [0]
    real = srv.scheduler.evict_out_of_window

    def counted():
        n = real()
        evicted[0] += n
        return n
    srv.scheduler.evict_out_of_window = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        srv.submit(p, n_new)
    fin = srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in fin.values())
    done = len(fin) == B and all(r.finish_reason == "length"
                                 for r in fin.values())
    say(f"  {label} Server: {B} requests of {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens, {n_new} new: {n_tok} tokens in "
        f"{wall:.3f} s ({n_tok / wall:.1f} tok/s); window "
        f"{srv.scheduler.window}, {evicted[0]} blocks evicted; every "
        f"request finished by length {done}")
    drained = srv.scheduler.alloc.n_free == srv.pc.n_blocks
    del srv
    torch.cuda.empty_cache()
    return done and drained, evicted[0]


def family_mixtral():
    """11c: mixtral-8x22b at full width, 4 of 56 layers, bf16: cure_run at
    --layers 2, r_max 256 (generate stage through the Server); 4 requests
    of 4,160-4,608-token prompts and 32 new tokens through the Server
    (windowed flash_attention in prefill, windowed paged_attention in
    decode, blocks evicted behind the 4096 window); one request's prefill
    and decode logits through the paged runtime against forward()."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import cure as cure_mod
    full = get_config("mixtral-8x22b")
    cfg = full.replace(n_layers=MIXTRAL_LAYERS,
                       groups=((full.groups[0][0], MIXTRAL_LAYERS),))
    real_get = cure_mod.get_config
    cure_mod.get_config = lambda name: cfg
    shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        run = cure_mod.cure_run(_cure_args(
            "mixtral-8x22b", 2, 256, "--calib-batches", "4",
            "--calib-batch", "4", "--calib-len", "512", "--device", "cuda"))
    finally:
        cure_mod.get_config = real_get
    shutil.rmtree(FAMILY_DIR)
    rep = run.report
    params, ccfg = run.cured_params, run.cured_cfg
    say(f"  11c mixtral-8x22b: {MIXTRAL_LAYERS} of {full.n_layers} layers, "
        f"{cfg.param_count()} params; stages_s "
        f"{json.dumps(rep['stages_s'])}; layers {rep['layers_compressed']}"
        f", saved_deployed {rep['params']['saved_deployed']}; generate "
        f"{rep['generate']['tokens']} tokens via "
        f"{rep['generate']['engine']}")
    del run
    torch.cuda.empty_cache()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in MIXTRAL_PROMPTS]
    c0 = _counts()
    served, evicted = _serve_long(params, ccfg, prompts, 32,
                                  "    mixtral CURed")
    launches = {k: v - c0[k] for k, v in _counts().items()}
    say(f"    Server launches {json.dumps(launches)}")
    # bf16: the runtime's own routing, its top-k flips against the
    # forward's (every step past the bound comes at or after one), then
    # the same tokens routed as the forward routes them, held to 2e-2
    tape = _RouteTape()
    with tape:
        own, seq = _paged_vs_forward(params, ccfg, prompts[0], 8,
                                     "    mixtral bf16, own routing", tape)
    n = len(prompts[0])
    witness = _flip_witness(dict(enumerate(own)), tape.flips(), n,
                            "    mixtral bf16")
    with _RouteTape(force=True, rec=tape.rec) as held:
        rel_held = max(_paged_vs_forward(
            params, ccfg, prompts[0], 8, "    mixtral bf16, the forward's "
            "routing", held, seq=seq)[0])
    steered = sum(d for _, d in held.flips())
    say(f"    tokens steered to the forward's experts: {steered}")
    del tape, held
    # and in f32, where no top-k flip hides a wrong cache
    rel = max(_paged_vs_forward(_to_f32(params),
                                ccfg.replace(dtype="float32"), prompts[0], 8,
                                "    mixtral f32")[0])
    del params
    say(f"    wall {time.perf_counter() - t0:.1f} s")
    checks = {
        "10,418,903,040 params": cfg.param_count() == MIXTRAL_PARAMS,
        "generate via the Server": rep["generate"]["engine"] == "serving",
        "served: every request finished, pool drained": served,
        "blocks evicted behind the window": evicted > 0,
        "windowed kernels launched": launches["flash_attention"] > 0
            and launches["paged_attention"] > 0,
        "bf16 steps past 2e-2 at or after a top-k flip": witness,
        "bf16 paged logits, the forward's routing, within 2e-2 of "
        "forward()": rel_held < BF16_TOL,
        "f32 paged logits within 2e-2 of forward()": rel < BF16_TOL,
    }
    torch.cuda.empty_cache()
    return [f"11c {k}" for k, ok in checks.items() if not ok]


def family_mamba2():
    """11d: mamba2-1.3b at full size (48 layers), bf16: cure_run at
    --layers 8, r_max 256 (generate stage through the engine); engine
    decode logits against forward()."""
    import shutil
    import torch
    from repro_torch.launch import cure as cure_mod
    shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    run = cure_mod.cure_run(_cure_args(
        "mamba2-1.3b", 8, 256, "--calib-batches", "4", "--calib-batch", "4",
        "--calib-len", "512", "--device", "cuda"))
    shutil.rmtree(FAMILY_DIR)
    rep = run.report
    want = _deployed_saving(run.cfg, rep["layers_compressed"], 256)
    say(f"  11d mamba2-1.3b: {run.cfg.n_layers} layers, "
        f"{run.cfg.param_count()} params; stages_s "
        f"{json.dumps(rep['stages_s'])}; layers {rep['layers_compressed']}"
        f", saved_deployed {rep['params']['saved_deployed']} (from the "
        f"shapes {want}); generate {rep['generate']['tokens']} tokens via "
        f"{rep['generate']['engine']}")
    c0 = _counts()
    _engine_vs_forward(run.cured_params, run.cured_cfg, 2, 256, 64,
                       "    mamba2 folded, bf16 (printed, not checked)")
    launches = {k: v - c0[k] for k, v in _counts().items()}
    cured, ccfg = run.cured_params, run.cured_cfg.replace(dtype="float32")
    rels = _engine_vs_forward(_to_f32(cured), ccfg, 2, 256, 64,
                              "    mamba2 folded, f32")[0]
    say(f"    engine run launches {json.dumps(launches)}; wall "
        f"{time.perf_counter() - t0:.1f} s")
    checks = {
        "8 layers of w_x": len(rep["layers_compressed"]) == 8
            and {w["name"] for w in rep["weights"]} == {"w_x"},
        "saved_deployed from the shapes":
            rep["params"]["saved_deployed"] == want,
        "generate via the engine": rep["generate"]["engine"] == "legacy",
        "cur_matmul launched": launches["cur_matmul"] > 0,
        "f32 engine logits within 2e-2": max(rels.values()) < BF16_TOL,
    }
    del run, cured
    torch.cuda.empty_cache()
    return [f"11d {k}" for k, ok in checks.items() if not ok]


def family_gemma():
    """11e: gemma3-1b at full size (26 layers, head dim 256), bf16, random
    weights from seed 0: one forward through flash_attention at d 256;
    the paged runtime at r 256 on a prompt past the 512 window against
    forward(); the Server on three such prompts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    cfg = get_config("gemma3-1b")
    t0 = time.perf_counter()
    params = init_params(0, cfg, "cuda")
    rng = np.random.RandomState(6)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 1024))).cuda()
    c0 = _counts()
    with torch.no_grad():
        logits = forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    fwd = {k: v - c0[k] for k, v in _counts().items()}
    finite = bool(torch.isfinite(logits.float()).all())
    say(f"  11e gemma3-1b: {cfg.n_layers} layers, head dim "
        f"{cfg.resolved_head_dim}, {cfg.param_count()} params; forward "
        f"(4, 1024) finite {finite}, launches {json.dumps(fwd)}")
    del logits
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (GEMMA_PROMPT, 600, 800)]
    c0 = _counts()
    with torch.no_grad():
        rel = max(_paged_vs_forward(params, cfg, prompts[0], 8,
                                    "    gemma3")[0])
    served, _ = _serve_long(params, cfg, prompts, 16, "    gemma3")
    launches = {k: v - c0[k] for k, v in _counts().items()}
    say(f"    paged launches {json.dumps(launches)}; wall "
        f"{time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    checks = {
        "forward finite": finite,
        "flash_attention at d 256 in the forward":
            fwd["flash_attention"] == cfg.n_layers,
        "paged_attention launched": launches["paged_attention"] > 0,
        "served: every request finished, pool drained": served,
        "logits within 2e-2 of forward()": rel < BF16_TOL,
    }
    return [f"11e {k}" for k, ok in checks.items() if not ok]


def phase_families():
    """Phase 11: the other families on the card. Each part is driven with
    the counts set to 0 just before it and read just after; each model is
    freed before the next. Returns the summed counts."""
    import torch
    say("== phase 11: the other families (MoE, Mamba-2, hybrid, d 256)")
    say(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB held by the "
        f"earlier phases")
    total = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    failed = []
    for name, part in (("11a", family_smokes), ("11b", family_jamba),
                       ("11c", family_mixtral), ("11d", family_mamba2),
                       ("11e", family_gemma)):
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        failed += part()
        torch.cuda.synchronize()
        n = _counts()
        for k, v in n.items():
            total[k] += v
        gc.collect()                # each model is freed before the next
        torch.cuda.empty_cache()
        say(f"  {name} launches {json.dumps(n)}, "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held after")
    say(f"  phase 11 launches {json.dumps(total)}")
    if failed:
        raise SystemExit(f"family checks failed: {failed}")
    return total


# ---------------------------------------------------------------------------
# phase 12: the distributed layer at world size 1 (NCCL, a 1 x 1 mesh)
# ---------------------------------------------------------------------------

# phase 12's FileStore (git-ignored; deleted at its end)
DIST_DIR = os.path.join(ROOT, "build", "chip_smoke_dist")
DIST_MIXTRAL_LAYERS = 2                       # of 56: ~10 GB in bf16
DIST_TOKENS = (4, 512)                        # the forwards' batch
DIST_LONG = 65_536                            # mixtral's 64K context, B 1
DIST_GEN = (2, 64, 8)                         # B, prompt, new (f32)
DIST_OLMO = (8, 128, 2)                       # B, S, steps (phase 9a's)


class _DropTape:
    """Counts the assignments the a2a body drops, by wrapping
    ``repro_torch.models.moe._moe_body_a2a`` (the routing is recomputed
    from the body's inputs, so a counted run is not a timed one)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.real, self.dropped, self.assigned = moe._moe_body_a2a, 0, 0

        def body(xs, router, *w, cfg, **kw):
            *_, rank, capE = moe._assignments(xs, router, cfg)
            self.dropped += int((rank >= capE).sum())
            self.assigned += rank.numel()
            return self.real(xs, router, *w, cfg=cfg, **kw)

        moe._moe_body_a2a = body
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._moe_body_a2a = self.real


def dist_mixtral(mesh):
    """12a: mixtral-8x22b at its own widths, 2 of 56 layers, bf16, one
    layer CURed (wq, wk at r_max 256, folded: cur_matmul): the forward
    and loss_fn under the 1 x 1 mesh (moe_impl "a2a": the routed body)
    against mesh=None (moe_dense); the a2a body against moe_dense alone;
    the a2a body at the 64K context; generate() under the mesh against
    mesh=None in f32."""
    import torch
    from repro_torch.configs import CURConfig, get_config
    from repro_torch.core import calibrate, compress_model
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import (
        Placed, drop_lead, map_specs, param_pspecs)
    from repro_torch.models import forward, init_params, loss_fn
    from repro_torch.models import moe
    from repro_torch.serve import generate
    full = get_config("mixtral-8x22b")
    cfg = full.replace(n_layers=DIST_MIXTRAL_LAYERS,
                       groups=((full.groups[0][0], DIST_MIXTRAL_LAYERS),))
    t0 = time.perf_counter()
    params = init_params(0, cfg, "cuda")
    B, S = DIST_TOKENS
    batch = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=0),
                        "cuda").batch_at(0)
    with torch.no_grad():
        calib = calibrate(params, cfg, [batch])
    # layer 1 (the angular selection keeps the first and last layers)
    params, cfg, info = compress_model(params, cfg, CURConfig(
        enabled=True, r_max=256, n_compress_layers=1, fold_u=True), calib,
        layers=[1])
    del calib
    torch.cuda.synchronize()
    say(f"  12a mixtral-8x22b: {DIST_MIXTRAL_LAYERS} of {full.n_layers} "
        f"layers (d {cfg.d_model}, E {cfg.n_experts}, k "
        f"{cfg.n_experts_per_tok}, F {cfg.moe_d_ff}, {cfg.dtype}), moe_impl "
        f"{cfg.moe_impl}; CURed layer {info.layers} "
        f"({', '.join(sorted({w.name for w in info.weights}))} at r "
        f"{sorted({w.rank for w in info.weights})}, folded); made in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    nodrop = cfg.replace(capacity_factor=8.0)
    out = {}
    with torch.no_grad():
        ref = forward(params, cfg, batch)
        mesh8 = forward(params, nodrop, batch, mesh)
        with _DropTape() as tape:
            mesh125 = forward(params, cfg, batch, mesh)
        out["rel8"] = rel_err(mesh8, ref)
        out["rel125"] = rel_err(mesh125, ref)
        l_ref = float(loss_fn(params, cfg, batch))
        l8 = float(loss_fn(params, nodrop, batch, mesh))
        out["loss_rel"] = abs(l8 - l_ref) / abs(l_ref)
        finite = bool(torch.isfinite(mesh8).all() and
                      torch.isfinite(mesh125).all())
        del ref, mesh8, mesh125
        say(f"    forward logits (B {B}, S {S}) under the mesh vs "
            f"mesh=None: capacity 8.0 {out['rel8']:.3e} (bound "
            f"{BF16_TOL}); capacity {cfg.capacity_factor} "
            f"{out['rel125']:.3e} with {tape.dropped} of {tape.assigned} "
            f"assignments dropped; loss_fn {l8:.6f} vs {l_ref:.6f} "
            f"(rel {out['loss_rel']:.3e})")
        ms = {"mesh=None (moe_dense)": device_ms(
                  lambda: forward(params, cfg, batch), n=5),
              "mesh, capacity 1.25": device_ms(
                  lambda: forward(params, cfg, batch, mesh), n=5),
              "mesh, capacity 8.0": device_ms(
                  lambda: forward(params, nodrop, batch, mesh), n=5)}
        say("    forward device ms: " + "; ".join(
            f"{k} {v:.3f}" for k, v in ms.items()))
        for label, m in (("mesh=None", None), ("mesh, capacity 1.25", mesh)):
            kind, busy = _kind_trace(params, cfg, batch, m)
            moe_ms = kind.get("moe_forward", 0.0)
            say(f"    trace of one forward, {label}: kernels busy "
                f"{busy:.3f} ms, moe_forward {moe_ms:.3f} ms "
                f"({moe_ms / max(busy, 1e-9):.1%}), attention "
                f"{kind.get('attention', 0.0):.3f}, cur_matmul kernels "
                f"{kind.get('cur_matmul kernels', 0.0):.3f}, "
                f"flash_attention kernels "
                f"{kind.get('flash_attention kernels', 0.0):.3f}")
        # one layer's MoE alone on the forward's token count (its
        # placement on the 1 x 1 mesh is the whole of each leaf)
        p = {k: params["groups"][0][0][k][0]
             for k in ("router", "w_gate", "w_up", "w_down")}
        lay = Placed(mesh, map_specs(drop_lead, param_pspecs(
            params, cfg, mesh)["groups"][0][0]))
        gen = torch.Generator(device="cuda").manual_seed(1)
        h = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                        dtype=p["w_gate"].dtype)
        body = {"moe_dense": device_ms(
                    lambda: moe.moe_dense(h, p, cfg), n=10),
                "a2a, capacity 1.25": device_ms(
                    lambda: moe.moe_forward(h, p, cfg, lay), n=10),
                "a2a, capacity 8.0": device_ms(
                    lambda: moe.moe_forward(h, p, nodrop, lay), n=10)}
        T = B * S
        k, E, F, D = (cfg.n_experts_per_tok, cfg.n_experts, cfg.moe_d_ff,
                      cfg.d_model)
        routed_ms = 1e3 * 3 * 2 * T * k * D * F / BF16_FLOPS
        say(f"    one layer's MoE, {T} tokens, device ms: " + "; ".join(
            f"{k_} {v:.3f}" for k_, v in body.items())
            + f"; routed FLOPs at the bf16 peak {routed_ms:.3f}; a2a at "
            f"1.25 / moe_dense {body['a2a, capacity 1.25'] / body['moe_dense']:.3f}")
        del h
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        hl = torch.randn((1, DIST_LONG, D), generator=gen, device="cuda",
                         dtype=p["w_gate"].dtype)
        long_ms = device_ms(lambda: moe.moe_forward(hl, p, cfg, lay), n=3)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        say(f"    a2a body at 1 x {DIST_LONG} tokens (the 64K context), "
            f"capacity {cfg.capacity_factor}: {long_ms:.3f} device ms, "
            f"{peak:.2f} GiB peak above the model; "
            f"{1e3 * long_ms / DIST_LONG:.3f} us a token")
        del hl, p
    # generate() under the mesh against mesh=None, f32, nothing dropped
    params = _to_f32(params)
    c32 = nodrop.replace(dtype="float32")
    Bg, Sg, n_new = DIST_GEN
    prompts = SyntheticLM(DataConfig(cfg.vocab_size, Sg, Bg, seed=4),
                          "cuda").batch_at(0)["tokens"]
    g_mesh = generate(params, c32, prompts, n_new, mesh=mesh).tokens
    g_ref = generate(params, c32, prompts, n_new).tokens
    same = torch.equal(g_mesh, g_ref)
    say(f"    generate() f32, {Bg} x {Sg} prompts, {n_new} new: mesh == "
        f"mesh=None {same}")
    del params
    torch.cuda.empty_cache()
    checks = {
        "logits finite": finite,
        "forward under the mesh within 2e-2 at capacity 8":
            out["rel8"] < BF16_TOL,
        "loss_fn under the mesh within 2e-2 at capacity 8":
            out["loss_rel"] < BF16_TOL,
        "tokens dropped at capacity 1.25": tape.dropped > 0,
        "generate under the mesh == mesh=None (f32)": same,
    }
    return [f"12a {k}" for k, ok in checks.items() if not ok]


def dist_olmo(mesh):
    """12b: olmo-1b at full width in f32 (phase 9a's batch 8 x 128): the
    train step under the 1 x 1 mesh against the unmeshed step (losses,
    through flash_attention under autograd), and the error-feedback step
    (its reduction through compressed_psum's all-gather) against the
    unmeshed EF step."""
    import torch
    from repro_torch.configs import OptimizerConfig, TrainConfig, get_config
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.dist.compression import init_residuals
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import make_ef_train_step, \
        make_train_step
    cfg = get_config("olmo-1b").replace(dtype="float32")
    B, S, steps = DIST_OLMO
    ds = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=0), "cuda")
    batches = [ds.batch_at(i) for i in range(steps)]
    opt = AdamW(OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=8))
    ef_cfg = TrainConfig(grad_compress="ef_int8")
    losses = {}
    for name, m, ef in (("unmeshed", None, False), ("mesh", mesh, False),
                        ("EF unmeshed", None, True), ("EF mesh", mesh, True)):
        params = init_params(0, cfg, "cuda")
        state = opt.init(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ls = []
        if ef:
            step = make_ef_train_step(cfg, opt, ef_cfg, m)
            resid = init_residuals(params)
            for b in batches:
                params, state, resid, l = step(params, state, resid, b)
                ls.append(float(l))
            del resid
        else:
            step = make_train_step(cfg, opt, mesh=m)
            for b in batches:
                params, state, l = step(params, state, b)
                ls.append(float(l))
        losses[name] = ls
        say(f"    12b {name}: losses {', '.join(f'{x:.6f}' for x in ls)} "
            f"({(time.perf_counter() - t0) * 1e3 / steps:.1f} ms a step)")
        del params, state
        torch.cuda.empty_cache()

    def close(a, b):
        return all(abs(x - y) <= F32_TOL * abs(y) for x, y in zip(a, b))

    say(f"  12b olmo-1b f32, batch {B} x {S}, {steps} steps: mesh == "
        f"unmeshed bitwise {losses['mesh'] == losses['unmeshed']}, EF "
        f"{losses['EF mesh'] == losses['EF unmeshed']}")
    checks = {
        "the mesh step's losses within 2e-5 of the unmeshed step's":
            close(losses["mesh"], losses["unmeshed"]),
        "the mesh EF step's losses within 2e-5 of the unmeshed EF step's":
            close(losses["EF mesh"], losses["EF unmeshed"]),
        "losses finite": all(math.isfinite(x) for v in losses.values()
                             for x in v),
    }
    return [f"12b {k}" for k, ok in checks.items() if not ok]


def dist_psum(mesh):
    """12c: compressed_psum at world size 1 is dq8(q8(x)), bit for bit."""
    import torch
    from repro_torch.dist.compression import compressed_psum
    from repro_torch.optim.adamw import dq8_rowwise, q8_rowwise
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((4096, 4096), generator=gen, device="cuda")
    got = compressed_psum(x, mesh, ("data", "model"))
    want = dq8_rowwise(*q8_rowwise(x))
    same = torch.equal(got, want)
    t = device_ms(lambda: compressed_psum(x, mesh, ("data", "model")), n=10)
    say(f"  12c compressed_psum (4096 x 4096 f32) == dq8(q8(x)) {same}; "
        f"{t:.3f} device ms")
    return [] if same else ["12c compressed_psum != dq8(q8(x))"]


def dist_nccl(mesh):
    """12d: each NCCL call the collective funnels make (all_gather,
    all_reduce sum and max, reduce_scatter, all_to_all_single), once on a
    card tensor over each one-rank group of the mesh, bf16 and f32: the
    funnels skip groups of one rank, so this keeps NCCL's wiring (dtypes,
    contiguity, groups) driven on the card. At one rank each is its
    operand."""
    import torch
    import torch.distributed as dist
    gen = torch.Generator(device="cuda").manual_seed(5)
    bad = []
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((64, 512), generator=gen, device="cuda").to(dtype)
        xt = x.t().contiguous()     # a funnel's non-contiguous operand
        for axis in mesh.mesh_dim_names:
            g = mesh.get_group(axis)
            parts = [torch.empty_like(xt)]
            dist.all_gather(parts, xt, group=g)
            s_, m_ = x.clone(), x.clone()
            dist.all_reduce(s_, group=g)
            dist.all_reduce(m_, op=dist.ReduceOp.MAX, group=g)
            rs = torch.empty_like(x)
            dist.reduce_scatter(rs, [p.contiguous() for p in x.chunk(1, 1)],
                                group=g)
            a2a = torch.empty_like(xt)
            dist.all_to_all_single(a2a, xt, group=g)
            torch.cuda.synchronize()
            got = {"all_gather": torch.equal(parts[0], xt),
                   "all_reduce": torch.equal(s_, x),
                   "all_reduce max": torch.equal(m_, x),
                   "reduce_scatter": torch.equal(rs, x),
                   "all_to_all_single": torch.equal(a2a, xt)}
            say(f"  12d NCCL over {axis!r} ({dist.get_world_size(g)} rank) "
                f"{dtype}: {json.dumps(got)}")
            bad += [f"12d {k} {axis} {dtype}" for k, ok in got.items()
                    if not ok]
    return bad


def phase_dist():
    """Phase 12: the distributed layer on the card at world size 1: an
    NCCL process group (a FileStore under build/, no TCP port) and a 1 x 1
    ("data", "model") mesh. Each part is driven with the counts set to 0
    just before it and read just after. Returns the summed counts."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    say("== phase 12: the distributed layer (NCCL, world size 1, 1 x 1 "
        "mesh)")
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(DIST_DIR, "store"), 1),
        rank=0, world_size=1)
    total = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    failed = []
    try:
        mesh = make_local_mesh((1, 1), ("data", "model"), device="cuda")
        say(f"  backend {dist.get_backend()}, mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names}")
        for name, part in (("12a", dist_mixtral), ("12b", dist_olmo),
                           ("12c", dist_psum), ("12d", dist_nccl)):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            failed += part(mesh)
            torch.cuda.synchronize()
            n = _counts()
            for k, v in n.items():
                total[k] += v
            gc.collect()
            torch.cuda.empty_cache()
            say(f"  {name} launches {json.dumps(n)}, "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    say(f"  phase 12 launches {json.dumps(total)}, "
        f"{time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise SystemExit(f"distributed checks failed: {failed}")
    return total


# ---------------------------------------------------------------------------
# phase 13: sharded training at world size 1 (placed params, remat, restore)
# ---------------------------------------------------------------------------

PLACED_OLMO = (8, 128, 2)                     # 13a: phase 9a's B, S; steps
CURED_OLMO = (4, 512, 4)                      # 13d: B, S, layers CURed
REMAT_TOKENS = (4, 2048)                      # 13b's batch
REMAT_STEPS = 2                               # step ms: the second step's
REMAT_POLICIES = ("off", "full", "save_mixer_outputs")


def _olmo_f32():
    from repro_torch.configs import get_config
    return get_config("olmo-1b").replace(dtype="float32")


def _ragged_mask(B, S, seed):
    """Row i keeps its first L_i tokens (row 0 none), on the card."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, S + 1, (B,), generator=gen)
    lens[0] = 0
    return (torch.arange(S)[None] < lens[:, None]).float().cuda()


def placed_olmo(mesh):
    """13a: the placed step against the unmeshed step and the
    replicated-input meshed step (olmo-1b f32, phase 9a's batch, unmasked
    and masked ragged), plain and EF. The initial params wait on the host, so only one run's
    trees are on the card at a time (beside the earlier phases' models).
    Returns (failures, the last placed run's params, specs)."""
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.configs import OptimizerConfig, TrainConfig
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.dist.compression import init_residuals
    from repro_torch.dist.sharding import Placed, param_pspecs, place
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import make_ef_train_step, \
        make_train_step
    cfg = _olmo_f32()
    B, S, steps = PLACED_OLMO
    ds = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=0), "cuda")
    plain = [ds.batch_at(i) for i in range(steps)]
    mask = _ragged_mask(B, S, 3)
    kinds = {"unmasked": plain,
             "masked, ragged": [dict(b, mask=mask) for b in plain]}
    opt = AdamW(OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=8))
    ef_cfg = TrainConfig(grad_compress="ef_int8")
    base = init_params(0, cfg, "cuda")
    specs = param_pspecs(base, cfg, mesh)
    base = tree_map(lambda t: t.cpu(), base)
    say(f"  13a olmo-1b f32, batch {B} x {S}, {steps} steps (masked: "
        f"{int(mask.sum())} of {B * S} tokens, row 0 none); remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}")
    losses = {}
    for kind, batches in kinds.items():
        for ef in (False, True):
            # the one-device step (EF: ef_compress_grads) is the
            # independent reference; the replicated-input meshed step
            # places its params on entry and runs the placed code
            runs = [("unmeshed", None), ("replicated mesh", mesh),
                    ("placed", "placed")]
            for name, m in runs:
                params = tree_map(lambda t: t.cuda(), base)
                if m == "placed":
                    params, m = place(params, specs, mesh), Placed(mesh,
                                                                   specs)
                state = opt.init(params)
                resid = init_residuals(params) if ef else None
                step = (make_ef_train_step(cfg, opt, ef_cfg, m) if ef
                        else make_train_step(cfg, opt, mesh=m))
                ls, ms = [], []
                for b in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if ef:
                        params, state, resid, l = step(params, state, resid,
                                                       b)
                    else:
                        params, state, l = step(params, state, b)
                    ls.append(float(l))
                    ms.append(1e3 * (time.perf_counter() - t0))
                losses[(kind, ef, name)] = ls
                say(f"    {kind}{', EF' if ef else ''}, {name}: losses "
                    f"{', '.join(f'{x:.6f}' for x in ls)}; step ms "
                    f"{', '.join(f'{x:.1f}' for x in ms)}")
                if (kind, ef, name) == ("masked, ragged", True, "placed"):
                    kept = params               # the last run: for 13c
                del params, state, resid
                torch.cuda.empty_cache()
    del base

    def close(a, b):
        return all(abs(x - y) <= F32_TOL * abs(y) for x, y in zip(a, b))

    checks = {}
    for kind in kinds:
        for ef in (False, True):
            got = losses[(kind, ef, "placed")]
            for ref in ("replicated mesh", "unmeshed"):
                want = losses.get((kind, ef, ref))
                if want is None:
                    continue
                label = f"{kind}{' EF' if ef else ''} placed vs {ref}"
                say(f"    {label}: bitwise {got == want}")
                checks[f"{label} within 2e-5"] = close(got, want)
    checks["losses finite"] = all(math.isfinite(x) for v in losses.values()
                                  for x in v)
    return [f"13a {k}" for k, ok in checks.items() if not ok], kept, specs


def remat_olmo(mesh):
    """13b: remat off / full / save_mixer_outputs on the placed step at 4
    x 2048 tokens: equal loss and gradients, peak memory, step ms."""
    import torch
    from repro_torch.configs import OptimizerConfig
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.dist import tree_flatten
    from repro_torch.dist.sharding import Placed, param_pspecs, place
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_loop import make_grads_fn, make_train_step
    cfg = _olmo_f32()
    B, S = REMAT_TOKENS
    ds = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=5), "cuda")
    batches = [ds.batch_at(i) for i in range(REMAT_STEPS)]
    params = init_params(0, cfg, "cuda")
    specs = param_pspecs(params, cfg, mesh)
    params = place(params, specs, mesh)
    lay = Placed(mesh, specs)
    gib = 2 ** 30
    opt = AdamW(OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=8))

    def of(policy):
        return cfg.replace(remat=policy != "off",
                           remat_policy="full" if policy == "off"
                           else policy)

    say(f"  13b olmo-1b f32, placed, batch {B} x {S}: "
        f"{sum(t.numel() for t in tree_flatten(params))} parameters, "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB held")
    ref, out = None, {}
    for policy in REMAT_POLICIES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        f0 = fa.launches
        t0 = time.perf_counter()
        l, g = make_grads_fn(of(policy), mesh=lay)(params, batches[0])
        l = float(l)
        grads_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        g = tree_flatten(g)
        if ref is None:
            ref, rel = (l, g), 0.0
        else:
            rel = max(rel_err(a, b) for a, b in zip(g, ref[1]))
        out[policy] = {"loss": l, "grad_rel": rel,
                       "grads_peak": peak / gib,
                       "grads_above": (peak - held) / gib,
                       "grads_ms": grads_ms,
                       "flash": fa.launches - f0}
        del g
    del ref
    for policy in REMAT_POLICIES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        state = opt.init(params)
        step = make_train_step(of(policy), opt, mesh=lay)
        torch.cuda.reset_peak_memory_stats()
        p, ms = params, []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, l = step(p, state, b)
            float(l)
            ms.append(1e3 * (time.perf_counter() - t0))
        out[policy]["step_peak"] = torch.cuda.max_memory_allocated() / gib
        out[policy]["step_ms"] = ms
        del p, state
    del params
    torch.cuda.empty_cache()
    for policy, r in out.items():
        say(f"    remat {policy}: loss {r['loss']:.6f}, gradients' max "
            f"scaled error vs off {r['grad_rel']:.3e}; gradient pass "
            f"{r['grads_ms']:.1f} ms, peak {r['grads_peak']:.2f} GiB "
            f"({r['grads_above']:.2f} above the params held), "
            f"flash_attention launches {r['flash']}; step ms "
            f"{', '.join(f'{x:.1f}' for x in r['step_ms'])}, step peak "
            f"{r['step_peak']:.2f} GiB")
    off = out["off"]
    checks = {"losses finite": all(math.isfinite(r["loss"])
                                   for r in out.values())}
    for policy in REMAT_POLICIES[1:]:
        r = out[policy]
        checks[f"{policy}: loss within 2e-5 of off"] = (
            abs(r["loss"] - off["loss"]) <= F32_TOL * abs(off["loss"]))
        checks[f"{policy}: gradients within 2e-5 of off"] = (
            r["grad_rel"] < F32_TOL)
        checks[f"{policy}: gradient pass peak below off's"] = (
            r["grads_peak"] < off["grads_peak"])
        checks[f"{policy}: step peak below off's"] = (
            r["step_peak"] < off["step_peak"])
        checks[f"{policy}: flash_attention twice a layer"] = (
            r["flash"] == 2 * cfg.n_layers)
    checks["off: flash_attention once a layer"] = off["flash"] == cfg.n_layers
    return [f"13b {k}" for k, ok in checks.items() if not ok]


def restore_placed(mesh, params, specs):
    """13c: 13a's last placed params saved whole, restored into placement
    (``restore(shardings=)``) and whole on the card: bit for bit."""
    import shutil
    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.dist import CheckpointManager, tree_flatten
    from repro_torch.dist.checkpoint import TensorSpec
    from repro_torch.dist.sharding import to_named, unplace
    d = os.path.join(DIST_DIR, "ckpt")
    whole = unplace(params, specs, mesh)
    tmpl = tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), whole)
    nbytes = sum(t.numel() * t.element_size() for t in tree_flatten(whole))
    mgr = CheckpointManager(d)
    t0 = time.perf_counter()
    mgr.save(0, whole)
    save_s = time.perf_counter() - t0
    del whole
    t0 = time.perf_counter()
    _, placed = mgr.restore(tmpl, shardings=to_named(specs, mesh))
    torch.cuda.synchronize()
    placed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, plain = mgr.restore(tmpl, device="cuda")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = all(a.device.type == "cuda" and torch.equal(a, b) for a, b in
               zip(tree_flatten(placed), tree_flatten(plain)))
    same_run = all(torch.equal(a, b) for a, b in
                   zip(tree_flatten(placed), tree_flatten(params)))
    shutil.rmtree(d, ignore_errors=True)
    say(f"  13c {nbytes / 2**30:.2f} GiB of placed params saved in "
        f"{save_s:.2f} s; restore(shardings=) {placed_s:.2f} s, "
        f"restore(device='cuda') {plain_s:.2f} s; bit-equal {same}, equal "
        f"to 13a's params {same_run}")
    checks = {"restore(shardings=) == restore(device='cuda')": same,
              "restored == the params saved": same_run}
    return [f"13c {k}" for k, ok in checks.items() if not ok]


def placed_cured_olmo(mesh):
    """13d: olmo-1b with its CUR targets (wq, wk, w_gate) CURed in 4
    layers (folded, r_max 256):
    the placed forward (each folded weight through cur_matmul on its
    local R) under no_grad, and in grad mode with nothing requiring a
    gradient, against the unplaced forward, in bf16 and f32."""
    import torch
    from repro_torch.configs import CURConfig, get_config
    from repro_torch.core import calibrate, compress_model
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import Placed, param_pspecs, place
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.models import forward, init_params
    cfg = get_config("olmo-1b")
    B, S, n_cur = CURED_OLMO
    batch = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=6),
                        "cuda").batch_at(0)
    params = init_params(0, cfg, "cuda")
    with torch.no_grad():
        calib = calibrate(params, cfg, [batch])
    params, cfg, info = compress_model(params, cfg, CURConfig(
        enabled=True, r_max=256, n_compress_layers=n_cur, fold_u=True),
        calib)
    del calib
    n_w = len(info.weights)
    say(f"  13d olmo-1b, layers {info.layers} CURed "
        f"({', '.join(sorted({w.name for w in info.weights}))} at r "
        f"{sorted({w.rank for w in info.weights})}, folded), batch {B} x "
        f"{S}")
    checks = {}
    for tol in (BF16_TOL, F32_TOL):
        if tol == F32_TOL:
            params, cfg = _to_f32(params), cfg.replace(dtype="float32")
        specs = param_pspecs(params, cfg, mesh)
        placed, lay = place(params, specs, mesh), Placed(mesh, specs)
        with torch.no_grad():
            ref = forward(params, cfg, batch)
            c0 = cm.launches
            got = forward(placed, cfg, batch, lay)
            n_off = cm.launches - c0
        c0 = cm.launches
        got_on = forward(placed, cfg, batch, lay)
        n_on = cm.launches - c0
        rel = max(rel_err(got, ref), rel_err(got_on, ref))
        say(f"    {cfg.dtype}: placed forward vs unplaced {rel:.3e} (bound "
            f"{tol}); cur_matmul launches {n_off} under no_grad, {n_on} "
            f"in grad mode ({n_w} folded weights)")
        checks[f"{cfg.dtype} placed forward within {tol}"] = (
            rel < tol and bool(torch.isfinite(got).all()))
        checks[f"{cfg.dtype} cur_matmul once per folded weight"] = (
            n_off == n_on == n_w)
        del ref, got, got_on, placed
    del params
    torch.cuda.empty_cache()
    return [f"13d {k}" for k, ok in checks.items() if not ok]


def phase_placed():
    """Phase 13: sharded training on the card at world size 1: an NCCL
    process group on phase 12's FileStore (under build/, no TCP port) and
    a 1 x 1 ("data", "model") mesh. Each part is driven with the counts
    set to 0 just before it and read just after. Returns the summed
    counts."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    say("== phase 13: sharded training (NCCL, world size 1, 1 x 1 mesh)")
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(DIST_DIR, "store"), 1),
        rank=0, world_size=1)
    total = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    failed, kept = [], {}
    try:
        mesh = make_local_mesh((1, 1), ("data", "model"), device="cuda")

        def a():
            out, kept["params"], kept["specs"] = placed_olmo(mesh)
            return out

        def c():
            out = restore_placed(mesh, kept["params"], kept["specs"])
            kept.clear()
            return out

        # 13c restores 13a's params, and 13d's CURed model is freed,
        # before 13b measures peak memory
        for name, part in (("13a", a), ("13c", c),
                           ("13d", lambda: placed_cured_olmo(mesh)),
                           ("13b", lambda: remat_olmo(mesh))):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            failed += part()
            torch.cuda.synchronize()
            n = _counts()
            for k, v in n.items():
                total[k] += v
            gc.collect()
            torch.cuda.empty_cache()
            say(f"  {name} launches {json.dumps(n)}, "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        kept.clear()
        dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    say(f"  phase 13 launches {json.dumps(total)}, "
        f"{time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise SystemExit(f"sharded training checks failed: {failed}")
    return total


# ---------------------------------------------------------------------------
# phase 14: placed serving at world size 1, and the dry run
# ---------------------------------------------------------------------------

PLACED_ENGINE = ENGINE_SHAPE                  # 14a: B, prompt, new tokens
PLACED_MAMBA = (4, 256, 32)                   # 14c: B, prompt, new tokens
DRYRUN_CELLS = (("--shape", "train_4k"),      # 14d, llama3.1-8b, 16 x 16
                ("--shape", "decode_32k", "--paged", "--cur"))
DRYRUN_DIR = os.path.join(ROOT, "build", "chip_smoke_dryrun")
DRYRUN_TIMEOUT = 300                          # seconds, both cells


def _cured_llama():
    """Phase 6's CURed llama3.1-8b when phase 6 did not run: cure()'s
    seed-0 weights, its calibration and its 10 layers at r_max 256,
    folded, without the save stage."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CURConfig
    from repro_torch.core import calibrate, compress_model
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    cfg = get_config("llama3.1-8b")
    params = init_params(0, cfg, "cuda")
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 512, 4, seed=0), "cuda")
    calib = calibrate(params, cfg, [ds.batch_at(i) for i in range(4)])
    cured, ccfg, _ = compress_model(params, cfg, CURConfig(
        r_max=256, n_compress_layers=10, selection="wanda_deim",
        svd="randomized", pipeline="batched", fold_u=True), calib)
    del params, calib
    return cured, ccfg


def _delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c0}


def _placed_generate(mesh, params, cfg, prompts, n_new, label):
    """generate() and one prefill + decode step, unplaced then placed:
    the failures of (tokens, logprobs, logits bit-equal; equal launches of
    every kernel). Returns (failures, launches of the placed run)."""
    import torch
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.serve import generate
    B, S = prompts.shape
    out = {}
    for name, m in (("unplaced", None), ("placed", mesh)):
        torch.cuda.synchronize()
        c0 = _counts()
        t0 = time.perf_counter()
        res = generate(params, cfg, prompts, n_new, mesh=m)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = _delta(c0, _counts())
        with torch.no_grad():
            cache = init_cache(cfg, B, S + 1, "cuda", mesh=m)
            l0, cache = prefill(params, cfg, {"tokens": prompts}, cache, m)
            pos = torch.full((B, 1), S, dtype=torch.int32, device="cuda")
            l1, _ = decode_step(params, cfg, {"tokens": res.tokens[:, :1]},
                                cache, pos, m)
        del cache
        out[name] = (res, (l0, l1), n)
        say(f"  {label} generate() {name}: {B} x {S} prompts, {n_new} new "
            f"tokens in {secs:.2f} s ({B * n_new / secs:.1f} tok/s); "
            f"launches {json.dumps(n)}")
    (ru, lu, nu), (rp, lp, np_) = out["unplaced"], out["placed"]
    checks = {
        "tokens equal": torch.equal(ru.tokens, rp.tokens),
        "logprobs bit-equal": torch.equal(ru.logprobs, rp.logprobs),
        "prefill and decode logits bit-equal": all(
            torch.equal(a, b) for a, b in zip(lu, lp)),
        "equal launches of every kernel": nu == np_,
    }
    say(f"  {label} placed == unplaced: {json.dumps(checks)}")
    return [f"{label}: {k}" for k, ok in checks.items() if not ok]


def placed_engine(mesh, model):
    """14a: generate() on phase 6's CURed llama3.1-8b (full width and
    depth, bf16) on 8 x 512 prompts, 64 new tokens, under the 1 x 1 mesh
    (params placed per param_pspecs, the cache per cache_pspecs) against
    mesh=None."""
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    params, cfg = model
    B, S, n_new = PLACED_ENGINE
    ds = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=3), "cuda")
    return _placed_generate(mesh, params, cfg, ds.batch_at(0)["tokens"],
                            n_new, "14a llama3.1-8b (CURed)")


def placed_server(mesh, model):
    """14b: the same model through Server(mesh=) on phase 7's workload A
    (all requests submitted at once, then drained: the same schedule in
    both runs) with a dense pool, a CUR-KV r 64 pool, and spec_k 4 drafted
    by itself on the dense pool, each against Server(mesh=None)."""
    import torch
    from repro_torch.serving import PagedConfig, Server
    params, cfg = model
    wl = _workloads(cfg.vocab_size)["A"]
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    bad = []
    for label, cur_kv, spec in (("dense", False, 0),
                                (f"CUR-KV r={KV_RANK}", True, 0),
                                (f"dense, spec_k {SPEC_K} self-draft", False,
                                 SPEC_K)):
        pc = PagedConfig.sized_for(max_len, 8, block_size=16, cur_kv=cur_kv,
                                   kv_rank=KV_RANK)
        kw = dict(draft_params=params, draft_cfg=cfg, spec_k=spec) \
            if spec else {}
        out = {}
        for name, m in (("unplaced", None), ("placed", mesh)):
            srv = Server(params, cfg, pc, max_concurrency=8, device="cuda",
                         mesh=m, **kw)
            torch.cuda.synchronize()
            c0 = _counts()
            for w in wl:
                srv.submit(w["prompt"], w["max_new_tokens"])
            finished = srv.drain()
            torch.cuda.synchronize()
            n = _delta(c0, _counts())
            st = srv.stats()
            out[name] = ({k: r.out_tokens for k, r in finished.items()}, n)
            say(f"  14b A {label} Server {name}: {st['tokens_generated']} "
                f"tokens, {st['tokens_per_s']:.1f} tok/s (busy "
                f"{st['tokens_per_s_busy']:.1f}); TPOT p50 "
                f"{st['tpot_p50_s'] * 1e3:.2f} ms; launches {json.dumps(n)}"
                + (f"; accept rate {st['spec_accept_rate']:.4f}"
                   if spec else ""))
            del srv
            torch.cuda.empty_cache()
        (tu, nu), (tp, np_) = out["unplaced"], out["placed"]
        checks = {"every request finished": len(tp) == len(wl),
                  "tokens equal": tu == tp,
                  "equal paged_attention launches":
                      nu["paged_attention"] == np_["paged_attention"] > 0,
                  "equal launches of every kernel": nu == np_}
        say(f"  14b A {label} placed == unplaced: {json.dumps(checks)}")
        bad += [f"14b {label}: {k}" for k, ok in checks.items() if not ok]
    return bad


def placed_mamba(mesh):
    """14c: mamba2-1.3b uncut (phase 11d's config, seed-0 weights, bf16)
    through the placed engine (its state and conv caches per
    cache_pspecs) against mesh=None."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("mamba2-1.3b")
    params = init_params(0, cfg, "cuda")
    B, S, n_new = PLACED_MAMBA
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                            generator=gen)
    return _placed_generate(mesh, params, cfg, prompts, n_new,
                            "14c mamba2-1.3b")


def placed_dryrun():
    """14d: the port's dry run (``repro_torch.launch.dryrun``'s CLI,
    llama3.1-8b on the fake 16 x 16 mesh, each cell with its flags) in a
    process of its own, after 14a-c (no timed part shares the host with
    it): its roofline lines and seconds; the process must have held no
    tensor on the card and launched no kernel. PyTorch initializes CUDA
    there at the first fake CUDA tensor (and a train cell's backward needs
    the device): the card memory the process holds (its context; nvidia-
    smi, against the reading before it started, this process idle
    meanwhile) is reported. Its figures are modelled (data-sheet
    constants), not measured."""
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    outs = [os.path.join(DRYRUN_DIR, f"cell{i}.json")
            for i in range(len(DRYRUN_CELLS))]
    argvs = [["--arch", "llama3.1-8b", *cell, "--out", out]
             for cell, out in zip(DRYRUN_CELLS, outs)]
    code = ("import time\nt0 = time.perf_counter()\n"
            "from repro_torch.launch import dryrun\n"
            "print(f'imported in {time.perf_counter() - t0:.1f} s')\n"
            f"for argv in {argvs!r}:\n    dryrun.main(argv)\n"
            "import subprocess\n"
            "print('card used', subprocess.run(['nvidia-smi', "
            "'--query-gpu=memory.used', '--format=csv,noheader,nounits'], "
            "capture_output=True, text=True).stdout.split()[0])\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    before = card_used_mib()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                            text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
        secs = time.perf_counter() - t0
        lines = stdout.strip().splitlines()
        label = "14d dryrun"
        for line in lines:
            if line.startswith("=== "):
                label = f"14d dryrun {line[4:]}"
            elif line.startswith(("  memory", "  cost", "  roofline")):
                say(f"  {label}:{line[1:]}")
            elif line.startswith("imported"):
                say(f"  14d dryrun: {line}")
        if proc.returncode != 0 or not all(map(os.path.exists, outs)):
            say(stderr[-3000:])
            return [f"14d dryrun: exit {proc.returncode}"]
        cells = []
        for out in outs:
            with open(out) as f:
                cells += json.load(f)
        for c in cells:
            if c["status"] != "OK":
                say(f"  14d dryrun {c['shape']}: {c['status']} "
                    f"{c.get('error', c.get('reason'))}")
        devices = [json.loads(line.split("device: ", 1)[1])
                   for line in lines if line.startswith("device: ")]
        held = [int(line.split()[-1]) - before for line in lines
                if line.startswith("card used")]
        say(f"  14d dryrun: {len(cells)} cells in {secs:.1f} s in their "
            f"process (after 14a-c); status "
            f"{[c['status'] for c in cells]}; kernels "
            f"{json.dumps([c.get('kernels') for c in cells])}; device "
            f"{json.dumps(devices[-1])}; the process held {held} MiB of "
            f"the card at its end (its CUDA context; nvidia-smi)")
        checks = {
            "every cell OK": all(c["status"] == "OK" for c in cells),
            "no tensor on the card": all(d["memory_allocated"] == 0
                                         for d in devices),
            "no kernel launched": not any(
                v for d in devices for v in d["launches"].values()),
            "kernels traced (shape-only)": all(c.get("kernels")
                                               for c in cells),
        }
        return [f"14d dryrun: {k}" for k, ok in checks.items() if not ok]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(DRYRUN_DIR, ignore_errors=True)


def phase_placed_serving(run):
    """Phase 14: placed serving at world size 1 (an NCCL group on a
    FileStore under build/, a 1 x 1 mesh) and then the dry run in a
    process of its own. Each part is driven with the counts set to 0 just
    before it and read just after. Returns the summed counts."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    say("== phase 14: placed serving (NCCL, world size 1, 1 x 1 mesh) and "
        "the dry run")
    t_phase = time.perf_counter()
    model = ((run.cured_params, run.cured_cfg) if run is not None
             else _cured_llama())
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    total = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    failed = []
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(DIST_DIR, "store"),
                                         1), rank=0, world_size=1)
        mesh = make_local_mesh((1, 1), ("data", "model"), device="cuda")
        for name, part in (("14a", lambda: placed_engine(mesh, model)),
                           ("14b", lambda: placed_server(mesh, model)),
                           ("14c", lambda: placed_mamba(mesh))):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            failed += part()
            torch.cuda.synchronize()
            n = _counts()
            for k, v in n.items():
                total[k] += v
            gc.collect()
            torch.cuda.empty_cache()
            say(f"  {name} launches {json.dumps(n)}, "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    failed += placed_dryrun()
    say(f"  phase 14 launches {json.dumps(total)}, "
        f"{time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise SystemExit(f"placed serving checks failed: {failed}")
    return total


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14",
                    help="comma-separated phases to run (all by default)")
    ap.add_argument("--cpu-progressive", nargs=2, metavar=("IN", "OUT"),
                    help="phase 10e's CPU run (started by phase 10)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build  # noqa: F401 (fails off-repo)
    if opts.cpu_progressive:
        return cpu_progressive(*opts.cpu_progressive)
    phases = {int(p) for p in opts.phases.split(",")}
    smi = phase_card()
    if 2 in phases:
        phase_build()
    errs = phase_kernels() if 3 in phases else None
    times = phase_times() if 4 in phases else None
    if 5 in phases:
        phase_small()
    run, stats_a = None, None
    if 6 in phases:
        main_launches, run, draft, ppl_uniform = phase_main()
        if 7 in phases:
            serve_launches, stats_a = phase_serve(run, draft)
        del draft                   # phase 7's restored draft: 14.6 GB
        torch.cuda.empty_cache()
    heal_case = zoo_model = None
    if 9 in phases:
        train_launches, heal_case, zoo_model = phase_train(run)
    if 10 in phases and run is not None:
        plan_launches = phase_plan(run, ppl_uniform, stats_a, zoo_model)
    if 11 in phases:
        family_launches = phase_families()
    if 12 in phases:
        dist_launches = phase_dist()
    if 13 in phases:
        placed_launches = phase_placed()
    if 14 in phases:
        serving_launches = phase_placed_serving(run)
    if 8 in phases and run is not None:
        phase_split(run, heal_case)
    if phases != set(range(1, 15)):
        say(f"ran phases {sorted(phases)} only: no kernel table")
        return 1
    # launches on the main paths: the last cure() run (its generate stage
    # included) with both perplexity passes (phase 6), phase 7's runs,
    # phase 9's training, healing and trained-weights runs, phase 10's
    # planning parts, phase 11's families, phase 12's meshed runs, phase
    # 13's placed training and phase 14's placed serving
    launches = {k: main_launches.get(k, 0) + serve_launches[k]
                + train_launches[k] + plan_launches[k] + family_launches[k]
                + dist_launches[k] + placed_launches[k]
                + serving_launches[k] for k in serve_launches}
    say(f"launches phase 6 {json.dumps(main_launches)}, phase 7 "
        f"{json.dumps(serve_launches)}, phase 9 "
        f"{json.dumps(train_launches)}, phase 10 "
        f"{json.dumps(plan_launches)}, phase 11 "
        f"{json.dumps(family_launches)}, phase 12 "
        f"{json.dumps(dist_launches)}, phase 13 "
        f"{json.dumps(placed_launches)}, phase 14 "
        f"{json.dumps(serving_launches)}")
    meta = {
        "cur_matmul": ("src/repro_torch/csrc/cur_matmul.cu",
                       "src/repro/kernels/cur_matmul/cur_matmul.py:48"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:82"),
        "paged_attention": (
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:108"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
