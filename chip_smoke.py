#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``. Phases, each on its own lines; any failure exits
nonzero:

  1. card     name, power limit, torch/CUDA versions; TF32 off
  2. build    every kernel of the main path, from ``src/repro_torch/csrc``
  3. kernels  each kernel against its plain PyTorch version, scale-relative
              max error < 2e-5 (f32) / < 2e-2 (bf16)
  4. times    kernel, plain version and one library call at the main
              path's shapes (median of 25 launches, CUDA events), beside
              the least time the card could take (bound)
  5. small    the folded forward at a small f32 size on the card against
              the same params on the CPU (plain versions), 2e-5
  6. main     ``cure()`` on full-width llama3.1-8b (random weights made on
              the card, 10 of 32 layers CURed at r_max 256), run
              ``CURE_RUNS`` times: the first (cold) run's stage times
              alone, then the median and range of the others; after the
              last run, perplexity of the original and the folded model
              and the launch counts of both kernels over that run

The last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``; the line before them is the kernel table.
"""
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

CUR_SHAPES = {"wq": (4096, 256, 4096), "wk": (4096, 256, 1024),
              "w_gate": (4096, 256, 14336)}   # (m, r, n) at r_max 256
CUR_M = 2048                                  # 4 x 512 tokens
FLASH_SHAPE = (4, 32, 8, 512, 128)            # B, H, K, S, d
CURE_RUNS = 4                                 # 1 cold + 3 warm cure() runs


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
    for name in _build.KERNELS:
        log = _build.lib_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")


def _randn(gen, shape, dtype, scale=1.0):
    import torch
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            ).to(dtype)


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
                  (96, 100, 24, 200, bf16, False)]
    for M, m, r, n, dt, main in cur_cases:
        x = _randn(gen, (M, m), dt)
        cu = _randn(gen, (m, r), dt, m ** -0.5)
        rr = _randn(gen, (r, n), dt, r ** -0.5)
        y = cm.cur_matmul(x, cu, rr)
        torch.cuda.synchronize()
        e = check(f"cur_matmul M={M} m={m} r={r} n={n} {dt}", y,
                  cur_matmul_ref(x, cu, rr), dt, main and dt == bf16)
        worst["cur_matmul"] = max(worst["cur_matmul"], e)
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
                  f"window={win} causal={causal} {dt}", o,
                  flash_attention_ref(q, kk, v, causal=causal, window=win,
                                      scale=scale), dt, main)
        worst["flash_attention"] = max(worst["flash_attention"], e)
    try:
        fa.flash_attention(_randn(gen, (1, 6, 32, 16), f32),
                           _randn(gen, (1, 4, 32, 16), f32),
                           _randn(gen, (1, 4, 32, 16), f32))
        failures.append("flash_attention H % K raise")
    except ValueError as exc:
        say(f"  flash_attention H=6 K=4 raises: {exc}")
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")
    return worst


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
        say(f"  cur_matmul {name} M={M} m={m} r={r} n={n}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}); {flops / ms / 1e9:.1f} TFLOP/s")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", bnd), ("bytes", nbytes), ("flops", flops)):
            tot[k] += v
    _, by = bound_ms(tot["bytes"], tot["flops"])
    rows["cur_matmul"] = dict(tot, bound_by=by)

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
        f"bound {bnd:.4f} ms ({by}); {flops / ms / 1e9:.1f} TFLOP/s")
    rows["flash_attention"] = {"ms": ms, "plain_ms": plain,
                               "library_ms": lib, "bound_ms": bnd,
                               "bound_by": by}
    return rows


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
    return {"cur_matmul": main_cur + fold_cur,
            "flash_attention": main_flash + fold_flash}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build  # noqa: F401 (fails off-repo)
    smi = phase_card()
    phase_build()
    errs = phase_kernels()
    times = phase_times()
    phase_small()
    launches = phase_main()
    meta = {
        "cur_matmul": ("src/repro_torch/csrc/cur_matmul.cu",
                       "src/repro/kernels/cur_matmul/cur_matmul.py:48"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:82"),
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
