"""The JAX package's side of tests/test_torch_dist.py, on 8 host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_jax_dist_ref.py INPUTS.pkl OUT.pkl

Runs every mesh case of tests/_dist_cases.py through the JAX package
(``moe_forward`` and its per-device dispatch under ``shard_map``,
``compressed_psum``, ``NamedSharding``'s device slices, ``forward`` and
``generate`` on a mesh) and pickles the results."""
import math
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dist_cases as dc  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.dist.compression import compressed_psum  # noqa: E402
from repro.models.model import forward  # noqa: E402
from repro.models.moe import (  # noqa: E402
    _rank_within_expert, moe_dense, moe_forward, route, shard_map)
from repro.serve.engine import generate  # noqa: E402


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
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
