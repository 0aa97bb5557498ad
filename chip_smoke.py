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
              flash kernel's zero-padded feature dims (CUR-KV ranks)
  4. times    kernel, plain version and one library call at the main
              paths' shapes (median of 25 launches, CUDA events), beside
              the least time the card could take (bound), with achieved
              GB/s and TFLOP/s and the host's time per call; each
              kernel's registers and spills from the -Xptxas -v log
  5. small    the folded forward at a small f32 size on the card against
              the same params on the CPU (plain versions), 2e-5; then
              that model served on the card and on the CPU, dense and
              CUR-KV pools: the greedy tokens must be identical
  6. main     ``cure()`` on full-width llama3.1-8b (random weights made on
              the card, 10 of 32 layers CURed at r_max 256), run
              ``CURE_RUNS`` times: the first (cold) run's stage times
              alone, then the median and range of the others; after the
              last run, perplexity of the original and the folded model
              and the launch counts of both kernels over that run
  7. serve    the last run's CURed model served by ``Server`` on the card
              (max_concurrency 8, block 16): workload A (the serve CLI's
              ``make_workload``) and workload B (loadgen burst, prompts
              256/512/1024, 64 new tokens), each on a dense pool and a
              CUR-KV pool at rank 64; per run tokens/s, TTFT, TPOT, pool
              bytes and the launches of all three kernels, with checks
  8. split    device time by kernel (torch.profiler, after every timed
              phase): cur_matmul per weight and pass against the
              torch.matmul chain, flash_attention and paged_attention
              against SDPA, and one traced folded perplexity pass (busy
              and idle share, top kernels)

The last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``; the line before them is the kernel table.
``--phases 1,2,3`` runs only the phases named (for a first check of a new
kernel); the kernel table and the last line need every phase.
"""
import argparse
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
CURE_RUNS = 4                                 # 1 cold + 3 warm cure() runs
PAGED_SHAPE = (8, 8, 4, 16, 69)               # B, K, G, bs, maxb (serving)
KV_RANK = 64                                  # CUR-KV pool rank, hd / 2
# workload B's decode contexts (prompts 256 / 512 / 1024 + up to 64 tokens)
RAGGED_CTX = (256, 375, 494, 613, 732, 851, 970, 1088)


def say(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    """{device kernel name: mean ms per call of fn} over n calls under
    torch.profiler, after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / n
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.self_device_time_total > 0}


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

    cur_cases = [(CUR_M,) + CUR_SHAPES[k] + (dt, True)
                 for k in CUR_SHAPES for dt in (bf16, f32)]
    cur_cases += [(96, 100, 24, 200, f32, False),
                  (96, 100, 24, 200, bf16, False),    # fused body (m 100)
                  (512, 1024, 16, 1024, bf16, False),
                  (512, 1024, 24, 1024, bf16, False),
                  (1024, 2048, 512, 1024, bf16, False),
                  (1024, 1000, 64, 520, bf16, False),  # split off a slice edge
                  (300, 512, 40, 264, bf16, False)]    # ragged M, last n tile
    for M, m, r, n, dt, main in cur_cases:
        x = _randn(gen, (M, m), dt)
        cu = _randn(gen, (m, r), dt, m ** -0.5)
        rr = _randn(gen, (r, n), dt, r ** -0.5)
        y = cm.cur_matmul(x, cu, rr)
        torch.cuda.synchronize()
        body = cm.plan(M, m, r, n, dt).body
        e = check(f"cur_matmul M={M} m={m} r={r} n={n} {dt} ({body})", y,
                  cur_matmul_ref(x, cu, rr), dt, main and dt == bf16)
        worst["cur_matmul"] = max(worst["cur_matmul"], e)
        if dt == bf16 and (main or m == 100):
            # no atomics: a second call gives the same bits
            same = torch.equal(y, cm.cur_matmul(x, cu, rr))
            say(f"  cur_matmul M={M} m={m} r={r} n={n} repeat "
                f"{'bit-identical' if same else 'DIFFERS'}")
            if not same:
                failures.append(f"cur_matmul repeat M={M} n={n}")
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
            say(f"  flash_attention main shape repeat "
                f"{'bit-identical' if same else 'DIFFERS'}")
            if not same:
                failures.append("flash_attention repeat")
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

    # the registry's flash adaptor zero-pads a feature dim between the
    # kernel's widths (rank-space CUR-KV prefill at r = 8, 24, 48: folded
    # queries carry the scale, the kernel gets 1.0), against the kernel's
    # plain version at the unpadded width
    from repro_torch.attention import registry
    for d, dt in [(8, f32), (24, f32), (48, f32), (8, bf16), (24, bf16),
                  (48, bf16)]:
        B, S, K, G = 2, 96, 2, 2
        qg = _randn(gen, (B, S, K, G, d), dt, d ** -0.5)
        kk = _randn(gen, (B, S, K, d), dt)
        v = _randn(gen, (B, S, K, d), dt)
        pos = torch.arange(S, device="cuda")[None].expand(B, S)
        f0 = fa.launches
        o = registry._mix_flash_cuda(qg, kk, v, pos, pos, 0, 1.0, chunk=0)
        torch.cuda.synchronize()
        ref = flash_attention_ref(
            qg.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, d),
            kk.transpose(1, 2), v.transpose(1, 2), scale=1.0)
        ref = ref.reshape(B, K, G, S, d).permute(0, 3, 1, 2, 4)
        check(f"flash_attention padded d={d} -> "
              f"{registry._padded_dim(d)} {dt}", o, ref, dt, False)
        if fa.launches != f0 + 1:
            failures.append(f"flash padded d={d}: kernel not launched")
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")
    return worst


def _paged_inputs(gen, r, ctxs=None):
    """bf16 inputs of paged_attention at the serving shape (PAGED_SHAPE):
    a random pool of B maxb blocks, each slot's table a random permutation
    of its blocks; ctx maxb bs - 1 for every slot, or ``ctxs`` (then the
    entries past a slot's context are unassigned, as the scheduler leaves
    them)."""
    import torch
    B, K, G, bs, maxb = PAGED_SHAPE
    bf16 = torch.bfloat16
    q = _randn(gen, (B, K, G, r), bf16)
    kp = _randn(gen, (B * maxb, bs, K, r), bf16)
    vp = _randn(gen, (B * maxb, bs, K, r), bf16)
    table = torch.randperm(B * maxb, device="cuda").reshape(B, maxb).int()
    if ctxs is None:
        ctx = torch.full((B,), maxb * bs - 1, dtype=torch.int32,
                         device="cuda")
    else:
        ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
        j = torch.arange(maxb, device="cuda")[None]
        table = torch.where(j <= ctx[:, None] // bs, table, -1).int()
    return q, kp, vp, table, ctx


def _sdpa_on_gathered(q, kp, vp, table, ctx):
    """The library yardstick of paged_attention, gather excluded: SDPA
    over the pool gathered once into a contiguous (B, K, L, r) view with a
    boolean mask. Returns the call to time."""
    import torch
    import torch.nn.functional as F
    B, maxb = table.shape
    _, bs, K, r = kp.shape
    L = maxb * bs
    tb = table.long().clamp(min=0)
    kc = kp[tb].reshape(B, L, K, r).transpose(1, 2).contiguous()
    vc = vp[tb].reshape(B, L, K, r).transpose(1, 2).contiguous()
    mask = (torch.arange(L, device="cuda")[None] <= ctx[:, None].long()
            )[:, None, None, :]
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
    for name, (m, r, n) in CUR_SHAPES.items():
        M = CUR_M
        x = _randn(gen, (M, m), bf16)
        cu = _randn(gen, (m, r), bf16, m ** -0.5)
        rr = _randn(gen, (r, n), bf16, r ** -0.5)
        ms = median_ms(lambda: cm.cur_matmul(x, cu, rr))
        plain = median_ms(lambda: cur_matmul_ref(x, cu, rr))
        lib = median_ms(lambda: torch.matmul(torch.matmul(x, cu), rr))
        nbytes = 2 * (M * m + m * r + r * n + M * n)
        flops = 2 * M * r * (m + n)
        bnd, by = bound_ms(nbytes, flops)
        say(f"  cur_matmul {name} M={M} m={m} r={r} n={n} "
            f"({cm.plan(M, m, r, n, bf16).body}): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}); {nbytes / ms / 1e6:.1f} GB/s, "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        say(f"    host {host_ms(lambda: cm.cur_matmul(x, cu, rr)):.4f} ms "
            f"per call (launches only)")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", bnd), ("bytes", nbytes), ("flops", flops)):
            tot[k] += v
    _, by = bound_ms(tot["bytes"], tot["flops"])
    rows["cur_matmul"] = dict(tot, bound_by=by)
    say(f"  cur_matmul wq + wk + w_gate: kernel {tot['ms']:.4f} ms, "
        f"library {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} "
        f"ms; {tot['bytes'] / tot['ms'] / 1e6:.1f} GB/s, "
        f"{tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s")

    B, H, K, S, d = FLASH_SHAPE
    q = _randn(gen, (B, H, S, d), bf16)
    k = _randn(gen, (B, K, S, d), bf16)
    v = _randn(gen, (B, K, S, d), bf16)
    scale = d ** -0.5
    ms = median_ms(lambda: fa.flash_attention(q, k, v, scale=scale))
    plain = median_ms(lambda: flash_attention_ref(q, k, v, scale=scale))
    lib = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    nbytes = 2 * (2 * B * H * S * d + 2 * B * K * S * d)
    flops = 4 * B * H * d * (S * (S + 1) // 2)      # live causal pairs
    bnd, by = bound_ms(nbytes, flops)
    say(f"  flash_attention B={B} H={H} K={K} S={S} d={d} causal: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
        f"bound {bnd:.4f} ms ({by}); {nbytes / ms / 1e6:.1f} GB/s, "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    say(f"    host {host_ms(lambda: fa.flash_attention(q, k, v, scale=scale)):.4f}"
        f" ms per call (launches only)")
    rows["flash_attention"] = {"ms": ms, "plain_ms": plain,
                               "library_ms": lib, "bound_ms": bnd,
                               "bound_by": by}

    # paged_attention at the serving path's full-width decode step: every
    # slot at the longest context phase 7 reaches (all maxb blocks live),
    # then at workload B's spread of contexts (ragged: the splits of the
    # shorter slots hold no live entry)
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B, K, G, bs, maxb = PAGED_SHAPE
    for r, ctxs in [(128, None), (KV_RANK, None), (128, RAGGED_CTX),
                    (KV_RANK, RAGGED_CTX)]:
        q, kp, vp, table, ctx = _paged_inputs(gen, r, ctxs)
        ms = median_ms(lambda: pa.paged_attention(q, kp, vp, table, ctx))
        plain = median_ms(lambda: paged_attention_ref(q, kp, vp, table, ctx))
        lib = median_ms(_sdpa_on_gathered(q, kp, vp, table, ctx))
        live = int((ctx.long() + 1).sum()) * K       # live (slot, head, t)
        nbytes = 2 * (2 * live * r + 2 * B * K * G * r)
        flops = 4 * live * G * r
        bnd, by = bound_ms(nbytes, flops)
        p = pa.plan(B, K, G, r, bs, maxb, bf16,
                    sms=pa._sm_count(torch.cuda.current_device()))
        span = (f"ctx={maxb * bs - 1}" if ctxs is None else
                f"ctx={min(ctxs)}-{max(ctxs)} (ragged)")
        say(f"  paged_attention B={B} K={K} G={G} r={r} bs={bs} maxb={maxb}"
            f" {span} ({p.body}, {p.splits} splits of "
            f"{p.entries_per_split} entries, {p.grid[0] * p.grid[1]} "
            f"blocks): kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
            f"(SDPA, gather excluded) {lib:.4f} ms, bound {bnd:.4f} ms "
            f"({by}); {nbytes / ms / 1e6:.1f} GB/s")
        say(f"    host {host_ms(lambda: pa.paged_attention(q, kp, vp, table, ctx)):.4f}"
            f" ms per call (launches only)")
        if r == 128 and ctxs is None:
            rows["paged_attention"] = {"ms": ms, "plain_ms": plain,
                                       "library_ms": lib, "bound_ms": bnd,
                                       "bound_by": by}
    from repro_torch.kernels import _build
    for name in _build.KERNELS:
        for fn, regs, st, ld in ptxas_report(name):
            say(f"  ptxas {name}: {fn}: {regs} registers, spill stores "
                f"{st} B, spill loads {ld} B")
    return rows


def _total(times):
    """The summed device time of kernel_ms's result, or why there is none."""
    if not times:
        return "not measured (the profiler saw no kernel)"
    return f"{sum(times.values()):.4f} ms"


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
    for cur_kv in (False, True):
        pc = PagedConfig.sized_for(max_len, 4, block_size=16, cur_kv=cur_kv,
                                   kv_rank=cfg.resolved_head_dim // 2)
        outs = {}
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


def phase_main():
    import torch
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import cure as cure_mod
    from repro_torch.train.evaluate import perplexity
    say("== phase 6: main path, llama3.1-8b at full width")
    args = cure_mod.parser().parse_args([
        "--arch", "llama3.1-8b", "--layers", "10", "--r-max", "256",
        "--selection", "wanda_deim", "--svd", "randomized",
        "--pipeline", "batched", "--calib-batches", "4",
        "--calib-batch", "4", "--calib-len", "512", "--device", "cuda"])
    # cure() runs CURE_RUNS times on the same seeds. The first run pays
    # the first use of every CUDA kernel and library handle (the linalg of
    # compress above all) and is reported alone; the others give the
    # median and range of each stage. The main path proper is the last
    # run: the counts are set to 0 just before it.
    stages, layers = [], set()
    for i in range(CURE_RUNS):
        if i == CURE_RUNS - 1:
            torch.cuda.reset_peak_memory_stats()
            cm.launches = 0
            fa.launches = 0
            t0 = time.perf_counter()
        run = cure_mod.cure_run(args)
        stages.append(run.report["stages_s"])
        layers.add(tuple(run.report["layers_compressed"]))
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
    ds = SyntheticLM(DataConfig(run.cfg.vocab_size, 512, 4, seed=1),
                     "cuda")
    evl = [ds.batch_at(1000 + i) for i in range(2)]
    ppl_orig = perplexity(run.params, run.cfg, evl)
    torch.cuda.synchronize()
    main_cur, main_flash = cm.launches, fa.launches
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
        f"flash_attention {main_flash}; folded perplexity pass: "
        f"cur_matmul {fold_cur} flash_attention {fold_flash}")
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
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"main path checks failed: {bad}")
    return ({"cur_matmul": main_cur + fold_cur,
             "flash_attention": main_flash + fold_flash}, run)


def phase_serve(run):
    """The CURed model of the last cure() run served on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.launch.serve import make_workload, run_continuous
    from repro_torch.models import forward
    from repro_torch.obs import loadgen
    from repro_torch.serving import PagedConfig, Server, runtime
    from repro_torch.serving import paged_cache as pcache
    say("== phase 7: serve, llama3.1-8b at full width (CURed, bf16)")
    params, cfg = run.cured_params, run.cured_cfg
    V = cfg.vocab_size
    workloads = {
        "A": make_workload(16, V, max_new=32),
        "B": loadgen.generate(loadgen.WorkloadSpec(
            n_requests=16, arrival="burst",
            prompt=loadgen.LengthDist(kind="choice",
                                      values=(256, 512, 1024)),
            gen=loadgen.LengthDist(kind="fixed", mean=64, hi=64),
            vocab_size=V, seed=0)),
    }
    launches = {"cur_matmul": 0, "flash_attention": 0, "paged_attention": 0}
    bad = []
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
                B = 8
                S = 16
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
                    params, cfg, pc, torch.from_numpy(toks),
                    torch.from_numpy(lengths), cache,
                    torch.from_numpy(table))
                ref = forward(params, cfg, {"tokens": torch.tensor(
                    [prompt], device="cuda")})[0, -1]
                rel = rel_err(logits[0], ref)
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
    profile_decode(params, cfg, workloads["B"])
    return launches


def phase_split(run):
    """Device time by kernel (torch.profiler), run last so that no profiler
    window precedes a timed phase: cur_matmul per weight and pass and the
    torch.matmul chain, flash_attention and paged_attention and SDPA at
    the main shapes (phase 4's); then
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
    say("== phase 8: device time by kernel (torch.profiler, bf16)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    for name, (m, r, n) in CUR_SHAPES.items():
        x = _randn(gen, (CUR_M, m), bf16)
        cu = _randn(gen, (m, r), bf16, m ** -0.5)
        rr = _randn(gen, (r, n), bf16, r ** -0.5)
        parts = kernel_ms(lambda: cm.cur_matmul(x, cu, rr))
        lib = kernel_ms(lambda: torch.matmul(torch.matmul(x, cu), rr))
        say(f"  cur_matmul {name}: " + ", ".join(
            f"{_pass_name(k)} {v:.4f} ms" for k, v in parts.items())
            + f" (sum {_total(parts)}); torch.matmul chain {_total(lib)} "
            f"(mean of 25 calls)")
    B, H, K, S, d = FLASH_SHAPE
    q = _randn(gen, (B, H, S, d), bf16)
    k = _randn(gen, (B, K, S, d), bf16)
    v = _randn(gen, (B, K, S, d), bf16)
    scale = d ** -0.5
    dev = kernel_ms(lambda: fa.flash_attention(q, k, v, scale=scale))
    lib = kernel_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    say(f"  flash_attention B={B} H={H} K={K} S={S} d={d} causal: "
        f"{_total(dev)}; SDPA {_total(lib)} (mean of 25 calls)")
    B, K, G, bs, maxb = PAGED_SHAPE
    for r, ctxs in [(128, None), (KV_RANK, None), (128, RAGGED_CTX)]:
        args = _paged_inputs(gen, r, ctxs)
        dev = kernel_ms(lambda: pa.paged_attention(*args))
        lib = kernel_ms(_sdpa_on_gathered(*args))
        span = (f"ctx={maxb * bs - 1}" if ctxs is None else
                f"ctx={min(ctxs)}-{max(ctxs)} (ragged)")
        say(f"  paged_attention B={B} K={K} G={G} r={r} bs={bs} {span}: "
            f"{_total(dev)}; SDPA (gather excluded) {_total(lib)} (mean of "
            f"25 calls)")
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build  # noqa: F401 (fails off-repo)
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8",
                    help="comma-separated phases to run (all by default)")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}
    smi = phase_card()
    if 2 in phases:
        phase_build()
    errs = phase_kernels() if 3 in phases else None
    times = phase_times() if 4 in phases else None
    if 5 in phases:
        phase_small()
    if 6 in phases:
        main_launches, run = phase_main()
        if 7 in phases:
            serve_launches = phase_serve(run)
        if 8 in phases:
            phase_split(run)
    if phases != set(range(1, 9)):
        say(f"ran phases {sorted(phases)} only: no kernel table")
        return 1
    # launches on the main paths: the last cure() run with both
    # perplexity passes (phase 6) and the four serve runs (phase 7)
    launches = {k: main_launches.get(k, 0) + serve_launches[k]
                for k in serve_launches}
    say(f"launches phase 6 {json.dumps(main_launches)}, phase 7 "
        f"{json.dumps(serve_launches)}")
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
