"""The port's side of tests/test_torch_dist.py: one spawn of 8 gloo ranks
on the CPU,

    python tests/_torch_dist_worker.py INPUTS.pkl OUTDIR

Each rank joins the group through a FileStore in OUTDIR (no TCP port),
runs every case of tests/_dist_cases.py on the (2, 4) ("data", "model")
and (2, 2, 2) ("pod", "data", "model") meshes, and pickles its results to
OUTDIR/rank<r>.pkl."""
import os
import pickle
import sys

os.environ["OMP_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dist_cases as dc  # noqa: E402


def _np(t):
    return t.detach().cpu().numpy()


def _tree_np(tree):
    from repro_torch.bridge import to_numpy
    return to_numpy(tree)


def _moe(meshes):
    from repro_torch.configs import get_smoke
    from repro_torch.dist.collectives import block
    from repro_torch.dist.sharding import (
        Placed, drop_lead, map_specs, param_pspecs, place)
    from repro_torch.models import moe
    base = get_smoke("mixtral-8x22b")
    out, disp = {}, {}
    for name, (mname, E, *_rest) in dc.MOE_CASES.items():
        mesh = meshes[mname]
        cfg = base.replace(**dc.moe_overrides(name))
        x, p = dc.moe_inputs(name)
        x = torch.from_numpy(x)
        p = {k: torch.from_numpy(v) for k, v in p.items()}
        # the layer's specs: those of a one-layer stacked tree, less the
        # repeats dim
        stacked = {"groups": [[{k: v[None] for k, v in p.items()}]]}
        lay = Placed(mesh, map_specs(drop_lead, param_pspecs(
            stacked, cfg, mesh)["groups"][0][0]))
        with torch.no_grad():
            out[name] = _np(moe.moe_forward(x, place(p, lay.specs, mesh),
                                            cfg, lay))
        # this rank's block of x (moe_forward's spec) and its dispatch
        spec, a2a, _ = moe._x_spec(x.shape, cfg, mesh)
        xs = x
        for d, axes in enumerate(spec):
            if axes:
                xs = block(xs, d, mesh, axes)
        _, fe, _, _, rank, capE = moe._assignments(xs, p["router"], cfg)
        E_loc = E // mesh.shape[-1] if a2a else E
        keep = rank < capE
        slot = (fe % E_loc) * capE + rank if a2a else rank
        slot_eff = torch.where(keep, slot, E_loc * capE if a2a else capE)
        disp[name] = [_np(a) for a in (fe, rank, keep, slot_eff)]
    return out, disp


def _train(meshes, inp):
    from repro_torch import bridge
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.dist.compression import init_residuals
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import train_loop as tl
    res = {}
    for name, (model, mname) in {**dc.TRAIN, **dc.EF_TRAIN}.items():
        mesh = meshes[mname]
        arch, over = dc.MODELS[model]
        cfg = get_smoke(arch).replace(**over)
        params = bridge.to_torch(inp["params"][model], "cpu")
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in inp["batches"][model]]
        opt = AdamW(OptimizerConfig(**dc.OPT))
        state = opt.init(params)
        r = {}
        if name in dc.EF_TRAIN:
            step = tl.make_ef_train_step(
                cfg, opt, TrainConfig(grad_compress="ef_int8"), mesh)
            resid = init_residuals(params)
            losses = []
            for b in batches:
                params, state, resid, l = step(params, state, resid, b)
                losses.append(float(l))
        else:
            _, g = tl.make_grads_fn(cfg, mesh=mesh)(params, batches[0])
            r["grads"] = _tree_np(g)
            step = tl.make_train_step(cfg, opt, mesh=mesh)
            losses = []
            for b in batches:
                params, state, l = step(params, state, b)
                losses.append(float(l))
        r["losses"] = losses
        r["params"] = _tree_np(params)
        res[name] = r
    return res


def _cfg(model, **over):
    from repro_torch.configs import get_smoke
    arch, base = dc.model_args(model)
    return get_smoke(arch).replace(**base, **over)


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _repair(meshes, inp):
    """The masked / ragged / micro-batched cases: the loss and the whole
    gradients of the mesh step's grads function (replicated params)."""
    from repro_torch import bridge
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import train_loop as tl
    out = {}
    for name, (mname, micro, _, _, model, fsdp) in dc.MASKED.items():
        cfg = _cfg(model, fsdp=fsdp)
        params = bridge.to_torch(inp["grad_params"][model], "cpu")
        fn = tl.make_grads_fn(cfg, TrainConfig(microbatch=micro),
                              meshes[mname])
        l, g = fn(params, _batch(dc.masked_batch(name, cfg.vocab_size)))
        out[name] = (float(l), _tree_np(g))
    return out


def _placed(meshes, inp):
    """Each placed case: the caller places the params, AdamW.init makes
    the moments on the shards, PLACED_STEPS steps run on them. Returns
    the losses, this rank's final shards and the bytes its step keeps."""
    from repro_torch import bridge
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.dist import tree_flatten
    from repro_torch.dist.sharding import Placed, param_pspecs, place
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import train_loop as tl
    out = {}
    for name, (model, mname, fsdp, quant) in dc.PLACED.items():
        mesh = meshes[mname]
        cfg = _cfg(model, fsdp=fsdp)
        whole = bridge.to_torch(inp["placed_params"][model], "cpu")
        specs = param_pspecs(whole, cfg, mesh)
        params = place(whole, specs, mesh)
        del whole
        opt = AdamW(OptimizerConfig(**dc.OPT, quantized_state=quant))
        state = opt.init(params)
        step = tl.make_train_step(cfg, opt, mesh=Placed(mesh, specs))
        losses = []
        for b in inp["placed_batches"][model]:
            params, state, l = step(params, state, _batch(b))
            losses.append(float(l))
        kept = tree_flatten({"params": params, "state": state})
        out[name] = {"losses": losses,
                     "leaves": [_np(t) for t in kept],
                     "bytes": sum(t.numel() * t.element_size()
                                  for t in kept)}
    return out


def _evaluate(meshes, inp):
    """perplexity and token_accuracy of olmo on its placed shards (fsdp,
    dm) and on the whole params without a mesh, on the first batch."""
    from repro_torch import bridge
    from repro_torch.dist.sharding import Placed, param_pspecs, place
    from repro_torch.train.evaluate import perplexity, token_accuracy
    mesh = meshes["dm"]
    cfg = _cfg("olmo", fsdp=True)
    whole = bridge.to_torch(inp["params"]["olmo"], "cpu")
    specs = param_pspecs(whole, cfg, mesh)
    lay = Placed(mesh, specs)
    placed = place(whole, specs, mesh)
    batches = [_batch(inp["batches"]["olmo"][0])]
    return {"placed": (perplexity(placed, cfg, batches, lay),
                       token_accuracy(placed, cfg, batches, lay)),
            "whole": (perplexity(whole, cfg, batches),
                      token_accuracy(whole, cfg, batches))}


def _restore(meshes, inp):
    """This rank's blocks of a sharded restore of the test's checkpoint."""
    from repro_torch import bridge
    from repro_torch.dist import CheckpointManager, tree_flatten
    from repro_torch.dist.checkpoint import TensorSpec
    from repro_torch.dist.sharding import param_pspecs, to_named
    model, mname = dc.RESTORE
    mesh = meshes[mname]
    params = bridge.to_torch(inp["params"][model], "cpu")
    specs = param_pspecs(params, _cfg(model, fsdp=True), mesh)
    tmpl = {"f32": params, "bf16": params}
    tmpl = bridge.tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype),
                           tmpl)
    _, tree = CheckpointManager(inp["ckpt_dir"]).restore(
        tmpl, shardings=to_named({"f32": specs, "bf16": specs}, mesh))
    return [_np(t.float()) for t in tree_flatten(tree)]


def _generate(meshes, inp):
    from repro_torch import bridge
    from repro_torch.configs import get_smoke
    from repro_torch.models import forward
    from repro_torch.serve import generate
    arch, over = dc.MODELS[dc.GEN["model"]]
    cfg = get_smoke(arch).replace(**over)
    params = bridge.to_torch(inp["gen_params"], "cpu")
    prompts, fwd_tokens = dc.gen_inputs(cfg.vocab_size)
    mesh = meshes["dm"]
    with torch.no_grad():
        logits = forward(params, cfg,
                         {"tokens": torch.from_numpy(fwd_tokens).long()},
                         mesh)
    toks = generate(params, cfg, torch.from_numpy(prompts), dc.GEN["new"],
                    mesh=mesh).tokens
    return {"forward": _np(logits), "generate": _np(toks)}


def _serve(meshes, inp):
    """Each SERVE case: the engine's prefill and greedy decode steps on
    placed params and a placed cache, then (for attention models) the
    paged runtime's prefill, decode steps and one greedy verify window on
    a placed pool. Returns the global logits and tokens and this rank's
    cache and pool shards."""
    from repro_torch import bridge
    from repro_torch.dist import tree_flatten
    from repro_torch.models.model import (
        decode_step, init_cache, place_on_entry, prefill)
    from repro_torch.serving import runtime
    from repro_torch.serving.paged_cache import (
        PagedConfig, init_paged_cache)
    from repro_torch.serving.speculative import verify_tokens
    out = {}
    for name, (model, mname, pool) in dc.SERVE.items():
        mesh = meshes[mname]
        cfg = _cfg(model)
        whole = bridge.to_torch(inp["serve_params"][model], "cpu")
        params, lay = place_on_entry(whole, cfg, mesh)
        prompts, drafts = (torch.from_numpy(a).long()
                           for a in dc.serve_inputs(cfg.vocab_size, name))
        B, S = prompts.shape
        r = {}
        with torch.no_grad():
            cache = init_cache(cfg, B, S + dc.SERVE_STEPS + 1, "cpu",
                               mesh=lay)
            logits, cache = prefill(params, cfg, {"tokens": prompts}, cache,
                                    lay)
            lg, toks = [_np(logits)], []
            for i in range(dc.SERVE_STEPS):
                nxt = logits.argmax(-1)
                toks.append(_np(nxt))
                pos = torch.full((B, 1), S + i, dtype=torch.int32)
                logits, cache = decode_step(params, cfg,
                                            {"tokens": nxt[:, None]}, cache,
                                            pos, lay)
                lg.append(_np(logits))
            r["dense"] = {"logits": lg, "tokens": toks,
                          "cache": [_np(t) for t in tree_flatten(cache)]}
            if pool is not None:
                pc = PagedConfig(block_size=dc.PAGED_BS,
                                 n_blocks=B * dc.PAGED_MAXB,
                                 max_blocks_per_seq=dc.PAGED_MAXB)
                cache = init_paged_cache(cfg, pc, "cpu", mesh=lay,
                                         kernel=pool == "kernel")
                table = torch.from_numpy(dc.paged_table())
                lens = torch.tensor(dc.PAGED_LENS)
                logits, cache = runtime.paged_prefill(
                    params, cfg, pc, prompts, lens, cache, table, lay)
                lg, toks, ctx = [_np(logits)], [], lens.clone()
                active = torch.ones((B,), dtype=torch.bool)
                for i in range(dc.SERVE_STEPS):
                    nxt = logits.argmax(-1)
                    toks.append(_np(nxt))
                    logits, cache = runtime.paged_decode(
                        params, cfg, pc, nxt[:, None], cache, table, ctx,
                        active, lay)
                    lg.append(_np(logits))
                    ctx = ctx + 1
                nxt = logits.argmax(-1)
                win = torch.cat([nxt[:, None], drafts], 1)
                emitted, n_emit, _, cache = verify_tokens(
                    params, cfg, pc, win, drafts, None, cache, table, ctx,
                    active, None, np.zeros(B, np.int64), lay, greedy=True)
                r["paged"] = {"logits": lg, "tokens": toks,
                              "emitted": _np(emitted),
                              "n_emit": _np(n_emit),
                              "pool": [_np(cache["k"]), _np(cache["v"])]}
        out[name] = r
    return out


def _psum(meshes):
    from repro_torch.dist.collectives import axes_index
    from repro_torch.dist.compression import compressed_psum, ef_psum_grads
    x = torch.from_numpy(dc.psum_inputs())
    out = {}
    for name, (mname, axes) in dc.PSUM_AXES.items():
        mesh = meshes[mname]
        r = axes_index(mesh, mesh.mesh_dim_names)
        out[name] = _np(compressed_psum(x[r:r + 1], mesh, axes))
    # error feedback over the 8 ranks: rank r's gradient is g[r]
    mesh = meshes["dm"]
    g = torch.from_numpy(dc.ef_inputs()[dist.get_rank()])
    resid = {"w": torch.zeros_like(g)}
    acc = torch.zeros_like(g)
    for _ in range(dc.EF_ROUNDS):
        total, resid = ef_psum_grads({"w": g}, resid, mesh,
                                     ("data", "model"))
        acc += total["w"]
    out["ef_mean"] = _np(acc / (dc.EF_ROUNDS * dc.WORLD))
    return out


def _funnels(meshes):
    """all_gather_cat and all_to_all over 'model' on a non-contiguous
    operand (a transposed block), and the record they leave."""
    from repro_torch.dist import collectives as col
    mesh = meshes["dm"]
    x = (torch.arange(24, dtype=torch.float32).reshape(6, 4)
         + 100 * dist.get_rank()).t()
    with col.recording() as rec:
        gathered = col.all_gather_cat(x, 0, mesh, "model")
        swapped = col.all_to_all(x, mesh, "model")
    return {"gather": _np(gathered), "a2a": _np(swapped),
            "record": dict(rec)}


def _q8_sharded(meshes):
    """int8 codes and row scales of this rank's block, the row max taken
    over the ranks that share the row."""
    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.optim.adamw import _q8, _q8_sqrt, sharded_rowmax
    mesh = meshes["dm"]
    spec = P(*dc.Q8_SPEC)
    x = local_shard(torch.from_numpy(dc.q8_inputs()), spec, mesh)
    rowmax = sharded_rowmax(mesh, spec)
    return [_np(a) for a in _q8(x, 0, rowmax) + _q8_sqrt(x * x, rowmax)]


def _distribute(meshes):
    from repro_torch.dist.sharding import P, distribute, local_shard
    out = {}
    for name, (mname, spec, shape) in dc.DIST_SPECS.items():
        mesh = meshes[mname]
        spec = None if spec is None else P(*spec)
        t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
            shape)
        dt = distribute({"w": t}, {"w": spec}, mesh)["w"]
        out[name] = (_np(dt.to_local()), _np(local_shard(t, spec, mesh)))
    return out


def _recovery():
    from repro_torch.dist.elastic import plan_recovery
    from repro_torch.launch.mesh import make_recovery_mesh
    failed = dc.RECOVERY["failed"]
    plan = plan_recovery(total_chips=dc.WORLD, failed_chips=len(failed),
                         tp_width=dc.RECOVERY["tp"], resume_step=3)
    healthy = [r for r in range(dc.WORLD) if r not in failed]
    mesh = make_recovery_mesh(plan, healthy, device="cpu")
    coord = mesh.get_coordinate()
    out = {"mesh": mesh.mesh.tolist(), "coord": coord}
    if coord is not None:
        t = torch.tensor([float(dist.get_rank())])
        dist.all_reduce(t, group=mesh.get_group("model"))
        out["model_sum"] = float(t)
    return out


def _rank(rank, inp_path, outdir):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(outdir, "store"), dc.WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=dc.WORLD)
    try:
        from repro_torch.launch.mesh import make_local_mesh
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        meshes = {k: make_local_mesh(shape, axes, device="cpu")
                  for k, (shape, axes) in dc.MESHES.items()}
        res = {}
        res["moe"], res["dispatch"] = _moe(meshes)
        res["psum"] = _psum(meshes)
        res["funnels"] = _funnels(meshes)
        res["slices"] = _distribute(meshes)
        res["q8"] = _q8_sharded(meshes)
        res["train"] = _train(meshes, inp)
        res.update(_generate(meshes, inp))
        res["recovery"] = _recovery()
        res["repair"] = _repair(meshes, inp)
        res["placed"] = _placed(meshes, inp)
        res["restore"] = _restore(meshes, inp)
        res["evaluate"] = _evaluate(meshes, inp)
        res["serve"] = _serve(meshes, inp)
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=tuple(sys.argv[1:3]), nprocs=dc.WORLD, join=True)
