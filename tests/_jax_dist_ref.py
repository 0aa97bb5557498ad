"""The JAX package's side of tests/test_torch_dist.py, on 8 host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_jax_dist_ref.py INPUTS.pkl OUT.pkl

Runs every mesh case of tests/_dist_cases.py through the JAX package
(``moe_forward`` and its per-device dispatch under ``shard_map``,
``compressed_psum``, ``NamedSharding``'s device slices, ``forward`` and
``generate`` on a mesh; the masked / micro-batched gradients and the
placed train steps under ``jax.jit(..., in_shardings=(p_sh, o_sh,
b_sh))``, as ``launch/dryrun.py`` lowers its train cells; a sharded
``CheckpointManager.restore``) and pickles the results."""
import math
import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dist_cases as dc  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.configs.base import OptimizerConfig, ShapeConfig  # noqa: E402
from repro.dist import sharding as shd  # noqa: E402
from repro.dist.checkpoint import CheckpointManager  # noqa: E402
from repro.dist.compression import compressed_psum  # noqa: E402
from repro.models.model import forward, loss_fn  # noqa: E402
from repro.models.moe import (  # noqa: E402
    _rank_within_expert, moe_dense, moe_forward, route, shard_map)
from repro.optim.adamw import AdamW  # noqa: E402
from repro.serve.engine import generate  # noqa: E402
from repro.train import train_loop as jloop  # noqa: E402


def mesh_of(name):
    """The case's mesh, with Auto axes (GSPMD propagates the shardings
    between the shard_map bodies, as under jit on a production mesh)."""
    shape, axes = dc.MESHES[name]
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def x_spec(name, mesh):
    """moe_forward's spec of x for the case (repro.models.moe :196-242)."""
    _, E, _, _, B, S, layout = dc.MOE_CASES[name]
    n = mesh.shape["model"]
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    b_ax = dp if (B % dp_size == 0 and B >= dp_size) else None
    if E % n == 0 and (S % n == 0 or layout == "fsdp"):
        if layout == "fsdp" and b_ax is not None and \
                B % (dp_size * n) == 0 and B >= dp_size * n:
            return P(dp + ("model",), None, None), True
        return P(b_ax, "model", None), True
    return P(b_ax, None, None), False


def dispatch(name, cfg, mesh, x, router):
    """Each device's routing of its block: experts, rank within expert,
    kept mask and slot, stacked in mesh-position order."""
    spec, a2a = x_spec(name, mesh)
    k, E = cfg.n_experts_per_tok, cfg.n_experts
    n = mesh.shape["model"]
    E_loc = E // n if a2a else E

    def body(xs):
        T = xs.shape[0] * xs.shape[1]
        xt = xs.reshape(T, xs.shape[-1])
        _, experts = route(xt, router, k)
        fe = experts.reshape(-1)
        rank = _rank_within_expert(fe)
        capE = max(1, math.ceil(T * k * cfg.capacity_factor / E))
        keep = rank < capE
        slot = ((fe % E_loc) * capE + rank) if a2a else rank
        cap = E_loc * capE if a2a else capE
        slot_eff = jnp.where(keep, slot, cap)
        return tuple(a[None] for a in (fe, rank, keep, slot_eff))

    out = P(tuple(mesh.axis_names))
    fn = shard_map(body, mesh, in_specs=(spec,), out_specs=(out,) * 4)
    return [np.asarray(a) for a in jax.jit(fn)(x)]


def cfg_of(model, **over):
    arch, base = dc.model_args(model)
    return get_smoke(arch).replace(**base, **over)


def batch_sharding(cfg, batch, mesh):
    """NamedShardings of a batch per ``batch_pspecs`` (a mask like the
    labels)."""
    B, S = batch["labels"].shape
    spec = shd.batch_pspecs(cfg, ShapeConfig("b", S, B, "train"),
                            mesh)["labels"]
    return {k: NamedSharding(mesh, spec or P()) for k in batch}


def position_of(mesh):
    return {d: i for i, d in enumerate(mesh.devices.flat)}


def slices(tree, mesh):
    """Per leaf (``jax.tree.leaves`` order), each device's (start, stop)
    per dim, in mesh-position order."""
    out = []
    for a in jax.tree.leaves(tree):
        idx = a.sharding.devices_indices_map(a.shape)
        out.append([[(sl.start or 0, a.shape[d] if sl.stop is None
                      else sl.stop) for d, sl in enumerate(idx[dev])]
                    for dev in mesh.devices.flat])
    return out


def compile_all(jobs):
    """{name: (jitted fn, args)} -> {name: compiled}, lowered and compiled
    on threads (XLA compiles outside the GIL)."""
    def one(job):
        fn, args = job
        return fn.lower(*args).compile()
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(jobs, pool.map(one, jobs.values())))


def repair(inp):
    """Loss and gradients of JAX's grads function (the train step's) on
    the masked / ragged / micro-batched batches."""
    jobs = {}
    for name, (mname, micro, _, _, model, fsdp) in dc.MASKED.items():
        params = jax.tree.map(jnp.asarray, inp["grad_params"][model])
        cfg = cfg_of(model, fsdp=fsdp)
        mesh = mesh_of(mname)
        batch = {k: jnp.asarray(v) for k, v in
                 dc.masked_batch(name, cfg.vocab_size).items()}
        p_sh = shd.to_named(shd.param_pspecs(params, cfg, mesh), mesh)
        fn = jloop._make_grads_fn(
            lambda p, b, cfg=cfg, mesh=mesh: loss_fn(p, cfg, b, mesh), micro)
        jobs[name] = (jax.jit(fn, in_shardings=(
            p_sh, batch_sharding(cfg, batch, mesh))), (params, batch))
        one = jloop._make_grads_fn(
            lambda p, b, cfg=cfg: loss_fn(p, cfg, b), micro)
        jobs[name + "/one"] = (jax.jit(one), (params, batch))
    out = {}
    compiled = compile_all(jobs)
    for name in dc.MASKED:
        l, g = compiled[name](*jobs[name][1])
        _, g1 = compiled[name + "/one"](*jobs[name][1])
        leaves = [np.asarray(x) for x in jax.tree.leaves(g)]
        # JAX's own gap between its GSPMD and one-device gradients
        gap = [float(np.abs(a - np.asarray(b)).max()
                     / (np.abs(a).max() + 1e-12))
               for a, b in zip(leaves, jax.tree.leaves(g1))]
        out[name] = (float(l), leaves, gap,
                     [jax.tree_util.keystr(k) for k, _ in
                      jax.tree_util.tree_leaves_with_path(g)])
    return out


def placed(inp):
    """PLACED_STEPS steps of each placed case under jit with the params,
    moments and batch placed per their specs: the losses, the final
    params and state (global arrays) and their device slices."""
    jobs, runs = {}, {}
    for name, (model, mname, fsdp, quant) in dc.PLACED.items():
        mesh = mesh_of(mname)
        cfg = cfg_of(model, fsdp=fsdp)
        params = jax.tree.map(jnp.asarray, inp["placed_params"][model])
        opt = AdamW(OptimizerConfig(**dc.OPT, quantized_state=quant))
        state = opt.init(params)
        p_sh = shd.to_named(shd.param_pspecs(params, cfg, mesh), mesh)
        o_sh = shd.to_named(shd.opt_state_pspecs(state, cfg, mesh), mesh)
        batches = [{k: jnp.asarray(v) for k, v in b.items()}
                   for b in inp["placed_batches"][model]]
        step = jax.jit(jloop.make_train_step(cfg, opt, None, mesh),
                       in_shardings=(p_sh, o_sh, batch_sharding(
                           cfg, batches[0], mesh)),
                       out_shardings=(p_sh, o_sh, None))
        p, s = jax.device_put(params, p_sh), jax.device_put(state, o_sh)
        jobs[name] = (step, (p, s, batches[0]))
        runs[name] = (mesh, p, s, batches)
    out = {}
    for name, step in compile_all(jobs).items():
        mesh, p, s, batches = runs[name]
        losses = []
        for b in batches:
            p, s, l = step(p, s, b)
            losses.append(float(l))
        tree = {"params": p, "state": s}
        out[name] = {"losses": losses, "slices": slices(tree, mesh),
                     "paths": [jax.tree_util.keystr(k) for k, _ in
                               jax.tree_util.tree_leaves_with_path(tree)],
                     "leaves": [np.asarray(a) for a in jax.tree.leaves(tree)]}
    return out


def restore(inp):
    """Each device's shard of every leaf of a sharded restore."""
    model, mname = dc.RESTORE
    mesh = mesh_of(mname)
    cfg = cfg_of(model, fsdp=True)
    params = inp["params"][model]
    specs = shd.param_pspecs(params, cfg, mesh)
    tmpl = {"f32": params, "bf16": params}
    sh = shd.to_named({"f32": specs, "bf16": specs}, mesh)
    tmpl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tmpl)
    _, tree = CheckpointManager(inp["ckpt_dir"]).restore(tmpl, sh)
    pos = position_of(mesh)
    out = []
    for a in jax.tree.leaves(tree):
        shards = sorted(a.addressable_shards, key=lambda x: pos[x.device])
        out.append([np.asarray(x.data.astype(jnp.float32)) for x in shards])
    return out


def _sh(mesh, spec):
    return NamedSharding(mesh, spec or P())


def serve(inp):
    """Each SERVE case as repro/launch/dryrun.py lowers its cells: prefill
    and decode under jit(in_shardings=(p_sh, c_sh, b_sh[, pos_sh]),
    out_shardings=(None, c_sh)), the paged steps with the pool and the
    slot inputs per paged_cache_pspecs / paged_decode_pspecs; the global
    logits and tokens, and the final cache / pool with their device
    slices. The cases run on 4 threads (XLA compiles and runs outside
    the GIL)."""
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(dc.SERVE, pool.map(
            lambda name: _serve_case(inp, name), dc.SERVE)))


def _serve_case(inp, name):
    from repro.models.model import decode_step, init_cache, prefill
    from repro.serving import runtime as srt
    from repro.serving.paged_cache import PagedConfig, init_paged_cache
    from repro.serving.speculative import verify_tokens
    model, mname, pool = dc.SERVE[name]
    mesh = mesh_of(mname)
    cfg = cfg_of(model)
    params = jax.tree.map(jnp.asarray, inp["serve_params"][model])
    p_sh = shd.to_named(shd.param_pspecs(params, cfg, mesh), mesh)
    params = jax.device_put(params, p_sh)
    prompts, drafts = (jnp.asarray(a) for a in
                       dc.serve_inputs(cfg.vocab_size, name))
    B, S = prompts.shape
    shape = ShapeConfig("serve", S, B, "prefill")
    cache = init_cache(cfg, B, S + dc.SERVE_STEPS + 1)
    c_sh = shd.to_named(shd.cache_pspecs(cache, cfg, shape, mesh), mesh)
    b_sh = {"tokens": _sh(mesh, shd.batch_pspecs(
        cfg, shape, mesh)["tokens"])}
    db_specs, pos_spec = shd.decode_batch_pspecs(cfg, shape, mesh)
    pf = jax.jit(lambda p, c, b, cfg=cfg, mesh=mesh: prefill(
        p, cfg, b, c, mesh), in_shardings=(p_sh, c_sh, b_sh),
        out_shardings=(None, c_sh))
    st = jax.jit(lambda p, c, b, pos, cfg=cfg, mesh=mesh: decode_step(
        p, cfg, b, c, pos, mesh), in_shardings=(
            p_sh, c_sh, {"tokens": _sh(mesh, db_specs["tokens"])},
            _sh(mesh, pos_spec)), out_shardings=(None, c_sh))
    logits, cache = pf(params, jax.device_put(cache, c_sh),
                       {"tokens": prompts})
    lg, toks = [np.asarray(logits)], []
    for i in range(dc.SERVE_STEPS):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(nxt))
        pos = jnp.full((B, 1), S + i, jnp.int32)
        logits, cache = st(params, cache, {"tokens": nxt[:, None]}, pos)
        lg.append(np.asarray(logits))
    r = {"dense": {"logits": lg, "tokens": toks,
                   "cache": [np.asarray(a)
                             for a in jax.tree.leaves(cache)],
                   "slices": slices(cache, mesh)}}
    if pool is not None:
        kern = pool == "kernel"
        pc = PagedConfig(block_size=dc.PAGED_BS,
                         n_blocks=B * dc.PAGED_MAXB,
                         max_blocks_per_seq=dc.PAGED_MAXB)
        pool_c = init_paged_cache(cfg, pc)
        pc_sh = shd.to_named(shd.paged_cache_pspecs(
            pool_c, cfg, mesh, kernel=kern), mesh)
        t_sp, tb_sp, cx_sp, ac_sp = (
            _sh(mesh, a) for a in shd.paged_decode_pspecs(
                cfg, B, dc.PAGED_MAXB, mesh, kernel=kern))
        pre_sh = _sh(mesh, shd.batch_pspecs(cfg, shape, mesh)["tokens"])
        ppf = jax.jit(lambda p, t, ln, c, tb, cfg=cfg, pc=pc, mesh=mesh:
                      srt.paged_prefill(p, cfg, pc, t, ln, c, tb, mesh),
                      in_shardings=(p_sh, pre_sh, cx_sp, pc_sh, tb_sp),
                      out_shardings=(None, pc_sh))
        pst = jax.jit(lambda p, t, c, tb, cx, ac, cfg=cfg, pc=pc,
                      mesh=mesh: srt.paged_decode(p, cfg, pc, t, c, tb,
                                                  cx, ac, mesh),
                      in_shardings=(p_sh, t_sp, pc_sh, tb_sp, cx_sp,
                                    ac_sp), out_shardings=(None, pc_sh))
        zeros = (jnp.zeros((B,), jnp.float32), jnp.zeros((B,), jnp.int32),
                 jnp.ones((B,), jnp.float32))
        keys = jnp.zeros((B, 2), jnp.uint32)

        def ver(p, w, d, c, tb, cx, ac, cfg=cfg, pc=pc, mesh=mesh):
            return verify_tokens(p, cfg, pc, w, d, None, c, tb, cx, ac,
                                 keys, jnp.zeros((B,), jnp.int32),
                                 *zeros, mesh, greedy=True)

        vst = jax.jit(ver, in_shardings=(
            p_sh, _sh(mesh, P(shd._dp_axes(mesh), None)),
            _sh(mesh, P(shd._dp_axes(mesh), None)), pc_sh, tb_sp, cx_sp,
            ac_sp), out_shardings=(None, None, None, pc_sh))
        table = jnp.asarray(dc.paged_table())
        ctx = jnp.asarray(dc.PAGED_LENS, jnp.int32)
        active = jnp.ones((B,), bool)
        logits, pool_c = ppf(params, prompts, ctx,
                             jax.device_put(pool_c, pc_sh), table)
        lg, toks = [np.asarray(logits)], []
        for i in range(dc.SERVE_STEPS):
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(nxt))
            logits, pool_c = pst(params, nxt[:, None], pool_c, table,
                                 ctx, active)
            lg.append(np.asarray(logits))
            ctx = ctx + 1
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        win = jnp.concatenate([nxt[:, None], drafts], 1)
        emitted, n_emit, _, pool_c = vst(params, win, drafts, pool_c,
                                         table, ctx, active)
        kv = {"k": pool_c["k"], "v": pool_c["v"]}
        r["paged"] = {"logits": lg, "tokens": toks,
                      "emitted": np.asarray(emitted),
                      "n_emit": np.asarray(n_emit),
                      "pool": [np.asarray(kv["k"]), np.asarray(kv["v"])],
                      "slices": slices(kv, mesh)}
    return r


def main(inp_path, out_path):
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {"moe": {}, "dense": {}, "dispatch": {}, "psum": {},
           "slices": {}}
    base = get_smoke("mixtral-8x22b")
    for name in dc.MOE_CASES:
        mesh = mesh_of(dc.MOE_CASES[name][0])
        cfg = base.replace(**dc.moe_overrides(name))
        x, p = dc.moe_inputs(name)
        p = {k: jnp.asarray(v) for k, v in p.items()}
        x = jnp.asarray(x)
        out["moe"][name] = np.asarray(
            jax.jit(lambda a: moe_forward(a, p, cfg, mesh))(x))
        out["dense"][name] = np.asarray(moe_dense(x, p, cfg))
        out["dispatch"][name] = dispatch(name, cfg, mesh, x, p["router"])
    xs = jnp.asarray(dc.psum_inputs())
    for name, (mname, axes) in dc.PSUM_AXES.items():
        mesh = mesh_of(mname)
        spec = P(tuple(mesh.axis_names), None)
        fn = shard_map(lambda a, axes=axes: compressed_psum(a, axes), mesh,
                       in_specs=spec, out_specs=spec)
        out["psum"][name] = np.asarray(jax.jit(fn)(xs))
    for name, (mname, spec, shape) in dc.DIST_SPECS.items():
        mesh = mesh_of(mname)
        sh = NamedSharding(mesh, P(*spec) if spec is not None else P())
        idx = sh.devices_indices_map(shape)
        out["slices"][name] = [
            [(s.start or 0, shape[d] if s.stop is None else s.stop)
             for d, s in enumerate(idx[dev])]
            for dev in mesh.devices.flat]
    mesh = mesh_of("dm")
    arch, over = dc.MODELS[dc.GEN["model"]]
    cfg = get_smoke(arch).replace(**over)
    params = jax.tree.map(jnp.asarray, inp["gen_params"])
    prompts, fwd_tokens = dc.gen_inputs(cfg.vocab_size)
    out["forward"] = np.asarray(jax.jit(
        lambda p, b: forward(p, cfg, b, mesh))(
            params, {"tokens": jnp.asarray(fwd_tokens)}))
    out["generate"] = np.asarray(generate(
        params, cfg, jnp.asarray(prompts), dc.GEN["new"], mesh=mesh).tokens)
    out["repair"] = repair(inp)
    out["placed"] = placed(inp)
    out["restore"] = restore(inp)
    out["serve"] = serve(inp)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
