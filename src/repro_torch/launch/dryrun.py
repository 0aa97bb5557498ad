"""Multi-pod dry run: trace every (arch x shape) step on the production
mesh with no device, record its memory and roofline terms
(``repro.launch.dryrun`` in the JAX package, which lowers and compiles on
512 placeholder host devices).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  ... --cur            # structurally CUR-compressed variant
  ... --paged [--paged-einsum-specs] [--spec K]   # decode shapes
  ... --out results.json

This process is rank 0 of a ``fake`` process group of 256 (512) ranks
(``launch.mesh.fake_production_mesh``), whose collectives move nothing.
Each cell makes its inputs as ``FakeTensor``s of device "cuda" at this
rank's shard shapes (the params per ``param_pspecs``, the optimizer state,
the caches per ``cache_pspecs``, the pools per ``paged_cache_pspecs``) and
runs the port's placed step on them under ``FakeTensorMode``: the route the
card takes, the kernels' wrappers included, whose fake inputs take their
shape-only path (``repro_torch.kernels._fake``). No tensor of a cell is
allocated on a card and no kernel is launched. On a host with a card,
PyTorch itself initializes CUDA at the first fake CUDA tensor (a context
on the card, and a one-element tensor it frees at once), and the autograd
engine that runs a train cell's backward needs that device: with the
cards hidden a train cell fails. ``roofline.analysis.recording`` counts the
step: FLOPs, essential bytes, collective bytes and the peak of the live
bytes made during the step.

Host reads: the paged steps find their pool write rows from the block
table, the contexts and the active mask on the host, so a paged cell
passes those as real host tensors of the right shape (every slot's table
full, at its last position; their values set only which rows are written)
and names them in its record's ``host_inputs``.

The record keeps the JAX package's keys per cell. The port counts every
layer's repeat as it runs, so its "direct" count is exact; the JAX
package's two-point extrapolation (two reduced configs, 1 and 2 repeats of
the scalable group: f(1) + (R - 1) * (f(2) - f(1))) stays the default for
the record's parity and gives the same numbers. ``compile_s`` is 0 (there
is nothing to compile) and ``lower_s`` the trace's seconds;
``bytes_xla_per_dev`` is every aten op's operand and result bytes, nothing
fused. The roofline terms are modelled from data-sheet constants
(``roofline.analysis``), not measured.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback

import torch

from repro_torch.bridge import flatten_up_to, unflatten_as
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import (
    CURConfig, OptimizerConfig, SHAPES, TrainConfig, shape_applicable)
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import axis_sizes, fake_production_mesh
from repro_torch.roofline import analysis as ra

GIB = 2 ** 30


def _reduced_cfg(cfg, k: int):
    """Clamp the scalable group's repeats to k. The JAX package unrolls
    the reduced configs (``static_loops``, which in the port only turns
    rematerialization on): here ``static_loops`` keeps the full config's
    remat choice for the scalable group, so a repeat costs what it costs
    in the full step."""
    groups = tuple((pat, min(reps, k)) for pat, reps in cfg.groups)
    n_layers = sum(len(pat) * reps for pat, reps in groups)
    remat = cfg.remat and ((cfg.scan_layers and _scalable_reps(cfg) > 1)
                           or cfg.static_loops)
    return cfg.replace(groups=groups, n_layers=n_layers,
                       scan_layers=False, static_loops=remat)


def _scalable_reps(cfg) -> int:
    """Repeats of the (single) scalable group."""
    rs = [reps for _, reps in cfg.groups if reps > 1]
    assert len(rs) <= 1, "extrapolation assumes one scalable group"
    return rs[0] if rs else 1


def _leaves(tree):
    return [t for t in flatten_up_to(tree, tree) if t is not None]


def _fake(tree, specs, mesh, device):
    """Fake tensors on ``device`` of this rank's shard shapes of the
    ``meta`` tree ``tree`` per ``specs`` (``None``: the shapes as they
    are)."""
    ts = flatten_up_to(tree, tree)
    ss = [None] * len(ts) if specs is None else flatten_up_to(tree, specs)
    return unflatten_as(tree, [
        None if t is None else torch.empty(
            shd.local_shape(t.shape, s, mesh), dtype=t.dtype, device=device)
        for t, s in zip(ts, ss)])


def _bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (each storage once)."""
    seen, n = set(), 0
    for t in _leaves(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


def _shard_bytes(tree, specs, mesh) -> int:
    """Bytes of a rank's shards of the ``meta`` tree per ``specs``."""
    n = 0
    for t, s in zip(flatten_up_to(tree, tree), flatten_up_to(tree, specs)):
        if t is not None:
            shape = shd.local_shape(t.shape, s, mesh)
            n += t.element_size() * int(torch.Size(shape).numel())
    return n


def _params(cfg, cur: bool):
    params = sp.param_specs(cfg)
    if cur:
        params = sp.structural_cur(params, cfg, CURConfig(r_max=256))
    return params


def _host_inputs(shape, pc):
    """Real host (table, ctx_len, active) of a paged decode step: every
    slot's table full, each slot at its last position (made outside the
    fake-tensor mode)."""
    from repro_torch.serving.paged_cache import host_math
    B = shape.global_batch
    with host_math():
        table = torch.arange(B * pc.max_blocks_per_seq,
                             dtype=torch.int32).reshape(B, -1)
        ctx = torch.full((B,), shape.seq_len - 1, dtype=torch.int32)
        return table, ctx, torch.ones((B,), dtype=torch.bool)


def _cell_fn(cfg, shape, mesh, *, cur: bool, microbatch: int,
             paged: bool, paged_kernel: bool, spec_k: int, device: str):
    """(step thunk, argument bytes per rank, host input names) of one
    cell; the thunk runs the port's placed step on fake inputs made by the
    caller's FakeTensorMode and returns its outputs."""
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.optim.adamw import AdamW
    from repro_torch.serving import paged_cache as pcache
    from repro_torch.serving import runtime as srt
    from repro_torch.serving import speculative as spd
    from repro_torch.train.train_loop import make_train_step
    params_m = _params(cfg, cur)
    p_specs = shd.param_pspecs(params_m, cfg, mesh)
    params = _fake(params_m, p_specs, mesh, device)
    lay = shd.Placed(mesh, p_specs)
    host = []
    if paged and shape.kind == "decode":
        srt.check_supported(cfg)
        cache_m, pc = sp.paged_cache_specs(cfg, shape)
        c_specs = shd.paged_cache_pspecs(cache_m, cfg, mesh,
                                         kernel=paged_kernel)
        cache = _fake(cache_m, c_specs, mesh, device)
        tokens_m, table_m, ctx_m, active_m = sp.paged_decode_input_specs(
            cfg, shape, pc)
        in_specs = shd.paged_decode_pspecs(
            cfg, shape.global_batch, pc.max_blocks_per_seq, mesh,
            kernel=paged_kernel)
        tokens = _fake(tokens_m, None, mesh, device)
        table, ctx, active = _host_inputs(shape, pc)
        host = ["table", "ctx_len", "active"]
        args = (_bytes(params) + _bytes(cache) + sum(
            _shard_bytes(t, s, mesh) for t, s in zip(
                (tokens_m, table_m, ctx_m, active_m), in_specs)))
        if spec_k:
            d_m = sp.fold_cur_struct(sp.structural_cur(
                sp.param_specs(cfg), cfg, CURConfig(r_max=64)))
            dp_specs = shd.draft_param_pspecs(d_m, cfg, mesh)
            d_params = _fake(d_m, dp_specs, mesh, device)
            pc_d = dataclasses.replace(
                pc, cur_kv=True, kv_rank=max(1, cfg.resolved_head_dim // 4))
            dc_m = pcache.init_paged_cache(cfg, pc_d, "meta")
            d_cache = _fake(dc_m, shd.paged_cache_pspecs(
                dc_m, cfg, mesh, kernel=paged_kernel), mesh, device)
            args += _bytes(d_params) + _bytes(d_cache)
            d_lay = shd.Placed(mesh, dp_specs)
            starts = torch.zeros((shape.global_batch,), dtype=torch.int64)

            def step():
                d_toks, _, dc = spd.draft_tokens(
                    d_params, cfg, pc_d, tokens, d_cache, table, ctx,
                    active, None, starts, spec_k, d_lay, greedy=True)
                ver = torch.cat([tokens.to(d_toks.dtype), d_toks], dim=1)
                emitted, n_emit, _, tc = spd.verify_tokens(
                    params, cfg, pc, ver, d_toks, None, cache, table, ctx,
                    active, None, starts, lay, greedy=True)
                return emitted, n_emit, tc, dc
        else:
            def step():
                return srt.paged_decode(params, cfg, pc, tokens, cache,
                                        table, ctx, active, lay)
    elif shape.kind == "train":
        # quantized moments for the configs above 1e11 params (8-bit Adam)
        quant = cfg.param_count() > 1e11
        opt = AdamW(OptimizerConfig(quantized_state=quant))
        state = opt.init(params)
        batch_m = sp.input_specs(cfg, shape)
        b_specs = shd.batch_pspecs(cfg, shape, mesh)
        batch = _fake(batch_m, None, mesh, device)
        args = (_bytes(params) + _bytes(state)
                + _shard_bytes(batch_m, b_specs, mesh))
        tc = TrainConfig(microbatch=microbatch) if microbatch else None
        train = make_train_step(cfg, opt, tc, lay)

        def step():
            return train(params, state, batch)
    elif shape.kind == "prefill":
        cache = _fake(init_cache(cfg, shape.global_batch, shape.seq_len,
                                 "meta", mesh=mesh), None, mesh, device)
        batch_m = sp.input_specs(cfg, shape)
        batch_m.pop("labels")
        b_specs = shd.batch_pspecs(cfg, shape, mesh)
        b_specs.pop("labels")
        batch = _fake(batch_m, None, mesh, device)
        args = (_bytes(params) + _bytes(cache)
                + _shard_bytes(batch_m, b_specs, mesh))

        def step():
            return prefill(params, cfg, batch, cache, lay)
    else:                                             # decode
        cache = _fake(init_cache(cfg, shape.global_batch, shape.seq_len,
                                 "meta", mesh=mesh), None, mesh, device)
        batch_m, pos_m = sp.decode_input_specs(cfg, shape)
        b_specs, pos_spec = shd.decode_batch_pspecs(cfg, shape, mesh)
        batch = _fake(batch_m, None, mesh, device)
        pos = _fake(pos_m, None, mesh, device)
        args = (_bytes(params) + _bytes(cache)
                + _shard_bytes(batch_m, b_specs, mesh)
                + _shard_bytes(pos_m, pos_spec, mesh))

        def step():
            return decode_step(params, cfg, batch, cache, pos, lay)
    return step, args, host


def trace_cell(cfg, shape, mesh, *, cur: bool = False, microbatch: int = 0,
               paged: bool = False, paged_kernel: bool = True,
               spec_k: int = 0, device: str = "cuda"):
    """Trace one cell's step on fake inputs on ``device`` ("cuda": the
    card's route, the kernels' shape-only paths; "cpu": the plain
    versions', for a host whose PyTorch has no CUDA, where some indexing
    ops of fake CUDA tensors fail). Returns a dict: ``record``
    (``roofline.analysis.recording``'s), ``argument_bytes``,
    ``output_bytes``, ``temp_bytes``, ``host_inputs``, ``seconds``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, host = _cell_fn(
            cfg, shape, mesh, cur=cur, microbatch=microbatch, paged=paged,
            paged_kernel=paged_kernel, spec_k=spec_k, device=device)
        with ra.recording() as rec:
            out = step()
        out_bytes = _bytes([t for t in torch.utils._pytree.tree_leaves(out)
                            if isinstance(t, torch.Tensor)
                            and t.device.type == device])
    return {"record": rec, "argument_bytes": args, "output_bytes": out_bytes,
            "temp_bytes": rec["temp_peak_bytes"], "host_inputs": host,
            "seconds": time.time() - t0}


def _costs(rec):
    coll = ra.collective_bytes(rec)
    return (float(rec["flops"]), float(rec["accessed_bytes"]),
            float(ra.essential_bytes(rec)), coll)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               cur: bool = False, microbatch: int = 0, paged: bool = False,
               paged_kernel: bool = True, spec_k: int = 0,
               verbose: bool = True, extrapolate: bool = True, mesh=None,
               cfg=None, shape=None, device: str = "cuda"):
    """Trace one (arch, shape, mesh) cell; the JAX package's
    ``lower_cell`` keys. ``mesh`` / ``cfg`` / ``shape`` override the
    production mesh, ``get_config(arch)`` and ``SHAPES[shape_name]``."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_label = "2x16x16" if multi_pod else "16x16"
    if not shape_applicable(arch, shape):
        return {"arch": arch, "shape": shape_name, "status": "SKIP",
                "cur": cur, "mesh": mesh_label,
                "reason": "full-attention arch at 500k (DESIGN.md §5)"}
    if paged:
        from repro_torch.serving.paged_cache import supports
        if shape.kind != "decode":
            return {"arch": arch, "shape": shape_name, "status": "SKIP",
                    "cur": cur, "paged": True, "mesh": mesh_label,
                    "reason": "paged runtime is decode-only"}
        if not supports(cfg):
            return {"arch": arch, "shape": shape_name, "status": "SKIP",
                    "cur": cur, "paged": True, "mesh": mesh_label,
                    "reason": "paged runtime needs attention mixers"}
    if mesh is None:
        mesh = fake_production_mesh(multi_pod=multi_pod)
    sizes = axis_sizes(mesh)
    mesh_name = "x".join(str(s) for s in sizes.values())
    chips = int(torch.Size(list(sizes.values())).numel())
    opts = dict(cur=cur, microbatch=microbatch, paged=paged,
                paged_kernel=paged_kernel, spec_k=spec_k, device=device)

    full = trace_cell(cfg, shape, mesh, **opts)
    raw_flops, raw_bytes, raw_ess, raw_coll = _costs(full["record"])
    R = _scalable_reps(cfg)
    if extrapolate and R > 1:
        one = trace_cell(_reduced_cfg(cfg, 1), shape, mesh, **opts)
        two = trace_cell(_reduced_cfg(cfg, 2), shape, mesh, **opts)
        f1, b1, e1, coll1 = _costs(one["record"])
        f2, b2, e2, coll2 = _costs(two["record"])

        def _extrap(x1, x2):
            """x1 + (R - 1) * (x2 - x1). The JAX package falls back to
            scaling the 2-rep module on a delta of 0 or less (GSPMD may
            reshard the reduced modules apart); the port's deltas are
            exact, and 0 is a term no repeat adds to."""
            return x1 + (R - 1) * (x2 - x1)

        flops, bytes_all = _extrap(f1, f2), _extrap(b1, b2)
        bytes_ess = _extrap(e1, e2)
        coll_total = _extrap(coll1["total"], coll2["total"])
        coll_detail = {k: int(_extrap(coll1[k], coll2[k])) for k in coll1}
        cost_basis = "2pt-extrapolated-unrolled-static"
        extra_s = round(one["seconds"] + two["seconds"], 1)
    else:
        flops, bytes_all, bytes_ess = raw_flops, raw_bytes, raw_ess
        coll_total = raw_coll["total"]
        coll_detail = dict(raw_coll)
        cost_basis = "direct"
        extra_s = 0.0

    mflops = ra.model_flops(cfg, shape)
    if cur:
        # useful flops of the CURed model scale with its parameter count
        dense_n = sp.count_struct_params(sp.param_specs(cfg))
        cur_n = sp.count_struct_params(
            sp.structural_cur(sp.param_specs(cfg), cfg, CURConfig()))
        mflops = mflops * (cur_n / dense_n)
    roof = ra.analyze(
        {"flops": flops, "essential_bytes": bytes_ess,
         "collectives": coll_detail}, cfg, shape, mesh_name, chips, arch,
        peak_mem_bytes=int(full["temp_bytes"] + full["argument_bytes"]),
        model_flops_global=mflops)
    kernels = full["record"]["kernels"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "cur": cur, "paged": paged, "spec_k": spec_k, "status": "OK",
        "cost_basis": cost_basis,
        "lower_s": round(full["seconds"], 1), "compile_s": 0.0,
        "compile_extra_s": extra_s,
        "argument_gib_per_dev": round(full["argument_bytes"] / GIB, 3),
        "temp_gib_per_dev": round(full["temp_bytes"] / GIB, 3),
        "output_gib_per_dev": round(full["output_bytes"] / GIB, 3),
        "argument_bytes_per_dev": full["argument_bytes"],
        "flops_per_dev": flops,
        "raw_scanned_flops_per_dev": raw_flops,
        "bytes_per_dev": bytes_ess,
        "bytes_xla_per_dev": bytes_all,
        "coll_bytes_per_dev": coll_total,
        "coll_detail": coll_detail,
        "model_flops": roof.model_flops_global,
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "dominant": roof.dominant,
        "useful_flop_ratio": round(roof.useful_flop_ratio, 4),
        "roofline_fraction": round(roof.roofline_fraction, 4),
        "kernels": kernels,
        "host_inputs": full["host_inputs"],
        "device": device,
        "basis": "modelled: data-sheet constants, fake-tensor trace",
    }
    if verbose:
        print(f"  memory: args={result['argument_gib_per_dev']} "
              f"temp={result['temp_gib_per_dev']} "
              f"out={result['output_gib_per_dev']} GiB/dev")
        print(f"  cost[{cost_basis}]: flops/dev={flops:.3e} "
              f"bytes/dev={bytes_ess:.3e} (all ops {bytes_all:.3e}) "
              f"coll/dev={coll_total:.3e}; kernels "
              + ", ".join(f"{k} x{v['calls']}" for k, v in kernels.items()))
        print(f"  roofline (modelled): compute={roof.compute_s*1e3:.1f}ms "
              f"memory={roof.memory_s*1e3:.1f}ms "
              f"collective={roof.collective_s*1e3:.1f}ms "
              f"-> {roof.dominant}-bound, "
              f"MFU-at-roof={roof.roofline_fraction:.2%}; traced in "
              f"{full['seconds'] + extra_s:.1f} s")
    return result


def _device_report() -> str:
    """Whether this process touched a card: CUDA initialized, the bytes
    its caching allocator holds (allocated) and keeps (reserved), the
    kernels' launch counts."""
    from repro_torch.kernels.cur_matmul import cur_matmul as cm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    init = torch.cuda.is_initialized()
    held = torch.cuda.memory_allocated() if init else 0
    kept = torch.cuda.memory_reserved() if init else 0
    return json.dumps({"cuda_initialized": init, "memory_allocated": held,
                       "memory_reserved": kept,
                       "launches": {"cur_matmul": cm.launches,
                                    "flash_attention": fa.launches,
                                    "paged_attention": pa.launches}})


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--cur", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="decode shapes: trace the paged block-table "
                         "runtime instead of the dense cache")
    ap.add_argument("--paged-einsum-specs", action="store_true",
                    help="with --paged: the pool placed by the einsum "
                         "specs (rank / block-pool fallbacks, the step "
                         "gathers the pool over 'model') instead of the "
                         "kernel's kv-head layout")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="with --paged: a draft-K / verify-1 speculative "
                         "window: target + structurally CURed draft "
                         "params and both pools placed on one mesh")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="one trace per cell (the direct count)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device: cuda (the card's "
                         "route; needs a PyTorch built with CUDA, not a "
                         "card) or cpu (the plain versions' route)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    label = "2x16x16" if mp else "16x16"
                    print(f"=== {arch} x {shape} x {label}"
                          f"{' [CUR]' if args.cur else ''}", flush=True)
                    try:
                        r = lower_cell(
                            arch, shape, multi_pod=mp, cur=args.cur,
                            microbatch=args.microbatch, paged=args.paged,
                            paged_kernel=not args.paged_einsum_specs,
                            spec_k=args.spec,
                            extrapolate=not args.no_extrapolate,
                            device=args.device)
                    except Exception as e:  # noqa: BLE001 record, go on
                        traceback.print_exc()
                        r = {"arch": arch, "shape": shape, "mesh": label,
                             "cur": args.cur, "status": "FAIL",
                             "error": f"{type(e).__name__}: {e}"[:500]}
                    results.append(r)
                    print(f"  -> {r['status']}", flush=True)
                    if args.out:
                        with open(args.out, "w") as f:
                            json.dump(results, f, indent=1)
    finally:
        from repro_torch.launch.mesh import teardown
        teardown()
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    print(f"\n{n_ok} OK, {n_skip} SKIP, "
          f"{len(results) - n_ok - n_skip} FAIL / {len(results)} cells")
    print(f"device: {_device_report()}")
    return results


if __name__ == "__main__":
    main()
