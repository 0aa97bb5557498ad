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
    from repro_torch.models import moe
    base = get_smoke("mixtral-8x22b")
    out, disp = {}, {}
    for name, (mname, E, *_rest) in dc.MOE_CASES.items():
        mesh = meshes[mname]
        cfg = base.replace(**dc.moe_overrides(name))
        x, p = dc.moe_inputs(name)
        x = torch.from_numpy(x)
        p = {k: torch.from_numpy(v) for k, v in p.items()}
        with torch.no_grad():
            out[name] = _np(moe.moe_forward(x, p, cfg, mesh))
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
        mean, resid = ef_psum_grads({"w": g}, resid, mesh, ("data", "model"))
        acc += mean["w"]
    out["ef_mean"] = _np(acc / dc.EF_ROUNDS)
    return out


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
        res["slices"] = _distribute(meshes)
        res["train"] = _train(meshes, inp)
        res.update(_generate(meshes, inp))
        res["recovery"] = _recovery()
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=tuple(sys.argv[1:3]), nprocs=dc.WORLD, join=True)
