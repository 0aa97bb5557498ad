"""Port parity for the distributed layer on 8 CPU ranks.

One spawn of 8 gloo ranks (tests/_torch_dist_worker.py) runs the port on
a (2, 4) ("data", "model") and a (2, 2, 2) ("pod", "data", "model") mesh;
one JAX subprocess with 8 host devices (tests/_jax_dist_ref.py) runs the
JAX package on the same meshes and inputs (tests/_dist_cases.py, made
from seeds). The single-device train steps of both packages run here
meanwhile. The cases:

  - moe_forward's a2a and TP bodies (with and without dropped tokens,
    S 16 and S 1, B 1, the fsdp layout) within 2e-5 of JAX's on the same
    mesh, and within JAX's own 2e-4 of moe_dense where nothing drops;
    each rank's experts, rank within expert, kept mask and slots equal to
    JAX's device at the same mesh position, exactly;
  - compressed_psum within 2e-5 scale-relative of JAX's under shard_map,
    and its error-feedback mean within JAX's 0.02 of the true mean;
  - distribute()'s local shard on each rank equal to the slice JAX's
    NamedSharding gives the device at that mesh position;
  - the sharded train step's first gradients within 2e-5 of the port's
    and JAX's single-device step (olmo on both meshes, mixtral through the
    a2a and the TP body), its losses within JAX's 5e-3, the params equal
    on every rank; the error-feedback step through compressed_psum;
  - forward() and generate() on the mesh against JAX's on its mesh;
  - an elastic recovery mesh over the healthy ranks.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.dist.compression import init_residuals as jax_init_residuals
from repro.models import init_params as jax_init_params
from repro.models import moe as jmoe
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train import train_loop as jloop
from repro_torch import bridge
from repro_torch.configs.base import OptimizerConfig
from repro_torch.dist import tree_flatten
from repro_torch.models import moe as tmoe
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_loop as tloop

import _dist_cases as dc
from _torch_helpers import assert_close, port_cfg

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "src")


def _cfg(model):
    arch, over = dc.MODELS[model]
    return jax_get_smoke(arch).replace(**over)


def _single_device(inp):
    """Both packages' single-device steps: first gradients and losses
    (and JAX's error-feedback losses)."""
    out = {"jax": {}, "port": {}, "jax_ef": {}}
    for model, jp in inp["params"].items():
        jcfg = _cfg(model)
        cfg = port_cfg(jcfg)
        batches = inp["batches"][model]
        jparams = jax.tree.map(jnp.asarray, jp)
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        _, jg = jax.jit(jax.value_and_grad(
            lambda p, b: jax_loss_fn(p, jcfg, b)))(jparams, jb[0])
        jopt = JaxAdamW(JaxOptimizerConfig(**dc.OPT))
        step = jax.jit(jloop.make_train_step(jcfg, jopt))
        p, s, losses = jparams, jopt.init(jparams), []
        for b in jb:
            p, s, l = step(p, s, b)
            losses.append(float(l))
        out["jax"][model] = (jax.tree.leaves(jax.device_get(jg)), losses)
        ef = jax.jit(jloop.make_ef_train_step(
            jcfg, jopt, JaxTrainConfig(grad_compress="ef_int8")))
        p, s, r, losses = jparams, jopt.init(jparams), \
            jax_init_residuals(jparams), []
        for b in jb:
            p, s, r, l = ef(p, s, r, b)
            losses.append(float(l))
        out["jax_ef"][model] = losses
        params = bridge.to_torch(jp, "cpu")
        tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
        _, g = tloop.make_grads_fn(cfg)(params, tb[0])
        opt = AdamW(OptimizerConfig(**dc.OPT))
        step = tloop.make_train_step(cfg, opt)
        p, s, losses = params, opt.init(params), []
        for b in tb:
            p, s, l = step(p, s, b)
            losses.append(float(l))
        out["port"][model] = (tree_flatten(bridge.to_numpy(g)), losses)
    return out


def _wait(proc, what):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{what}:\n{out}\n{err}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    params = {m: jax.device_get(jax_init_params(jax.random.PRNGKey(i),
                                                _cfg(m)))
              for i, m in enumerate(dc.MODELS)}
    inp = {"params": params,
           "batches": {m: dc.train_batches(_cfg(m).vocab_size, i)
                       for i, m in enumerate(dc.MODELS)},
           "gen_params": params[dc.GEN["model"]]}
    inp_path = str(tmp / "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=_SRC, OMP_NUM_THREADS="1")
    worker = subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "_torch_dist_worker.py"),
         inp_path, str(tmp)], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count="
                          f"{dc.WORLD}")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "_jax_dist_ref.py"), inp_path,
         str(tmp / "jax.pkl")], env=jenv, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        single = _single_device(inp)
        _wait(worker, "torch ranks")
        _wait(ref, "JAX reference")
    finally:
        for proc in (worker, ref):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ranks = []
    for r in range(dc.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(tmp / "jax.pkl", "rb") as f:
        jref = pickle.load(f)
    return {"ranks": ranks, "jax": jref, "single": single}


# ---------------------------------------------------------------------------
# MoE bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(dc.MOE_CASES))
def test_moe_forward_matches_jax_on_the_mesh(run, name):
    want = run["jax"]["moe"][name]
    for r in run["ranks"]:                       # the global result on each
        assert r["moe"][name].shape == want.shape
        assert_close(r["moe"][name], want, 2e-5)


@pytest.mark.parametrize("name", [n for n, c in dc.MOE_CASES.items()
                                  if c[3] == 8.0])
def test_moe_forward_matches_dense_oracle(run, name):
    """Nothing drops at capacity 8: JAX's own bound against moe_dense."""
    err = np.abs(run["ranks"][0]["moe"][name]
                 - run["jax"]["dense"][name]).max()
    assert err < 2e-4, err


@pytest.mark.parametrize("name", list(dc.MOE_CASES))
def test_dispatch_matches_jax_per_rank(run, name):
    """Experts, rank within expert, kept mask and slot of every rank's
    assignments equal those of JAX's device at the same mesh position."""
    jfe, jrank, jkeep, jslot = run["jax"]["dispatch"][name]
    for i, r in enumerate(run["ranks"]):
        fe, rank, keep, slot = r["dispatch"][name]
        assert np.array_equal(fe, jfe[i]), i
        assert np.array_equal(rank, jrank[i]), i
        assert np.array_equal(keep, jkeep[i]), i
        assert np.array_equal(slot, jslot[i]), i
    if name.endswith("drop") and dc.MOE_CASES[name][5] > 1:
        assert not all(k.all() for k in jkeep), "no token dropped"


@pytest.mark.parametrize("fe", [
    np.random.default_rng(0).integers(0, 8, 64),
    np.random.default_rng(1).integers(0, 3, 257),
    np.zeros(17, np.int64), np.arange(12)[::-1].copy(),
    np.repeat(np.arange(5), 4)], ids=["rand8", "rand3", "same", "rev",
                                      "runs"])
def test_rank_within_expert_matches_jax(fe):
    want = np.asarray(jmoe._rank_within_expert(jnp.asarray(fe, jnp.int32)))
    got = tmoe._rank_within_expert(torch.from_numpy(fe)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("form", ["dense", "cur", "folded"])
def test_expert_mm_matches_jax(form):
    rng = np.random.default_rng(3)
    E, C, D, F, r = 3, 5, 16, 24, 4

    def a(*s):
        return rng.standard_normal(s).astype(np.float32)

    h = a(E, C, D)
    w = {"dense": a(E, D, F),
         "cur": {"C": a(E, D, r), "U0": a(E, r, r), "dU": a(E, r, r),
                 "R": a(E, r, F)},
         "folded": {"CU": a(E, D, r), "R": a(E, r, F)}}[form]
    want = jmoe._expert_mm(jnp.asarray(h), jax.tree.map(jnp.asarray, w))
    got = tmoe._expert_mm(torch.from_numpy(h), bridge.to_torch(w, "cpu"))
    assert_close(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# compressed collectives, placement, recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(dc.PSUM_AXES))
def test_compressed_psum_matches_jax(run, name):
    want = run["jax"]["psum"][name]
    got = np.concatenate([r["psum"][name] for r in run["ranks"]])
    assert_close(got, want, 2e-5)


def test_ef_psum_mean_converges_to_true_mean(run):
    """Error feedback over 8 ranks: the mean of 50 compressed means is
    within JAX's 0.02 (tests/test_distributed.py) of the true mean."""
    true = dc.ef_inputs().mean(axis=0)
    for r in run["ranks"]:
        got = r["psum"]["ef_mean"]
        assert np.abs(got - true).max() / np.abs(true).max() < 0.02


@pytest.mark.parametrize("name", list(dc.DIST_SPECS))
def test_distribute_matches_jax_device_slices(run, name):
    _, _, shape = dc.DIST_SPECS[name]
    full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    for i, r in enumerate(run["ranks"]):
        want = full[tuple(slice(a, b)
                          for a, b in run["jax"]["slices"][name][i])]
        dt_local, shard = r["slices"][name]
        assert np.array_equal(dt_local, want), i
        assert np.array_equal(shard, want), i


def test_recovery_mesh_over_the_healthy_ranks(run):
    healthy = [r for r in range(dc.WORLD) if r not in dc.RECOVERY["failed"]]
    mesh = [healthy[:2], healthy[2:4]]           # dp 2 x tp 2, 2 spares
    for rank, r in enumerate(run["ranks"]):
        rec = r["recovery"]
        assert rec["mesh"] == mesh
        if rank in healthy[:4]:
            i = healthy.index(rank)
            assert list(rec["coord"]) == [i // 2, i % 2]
            assert rec["model_sum"] == float(sum(mesh[i // 2]))
        else:
            assert rec["coord"] is None


# ---------------------------------------------------------------------------
# the mesh train step, forward and generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(dc.TRAIN))
def test_sharded_grads_match_single_device(run, name):
    model = dc.TRAIN[name][0]
    got = tree_flatten(run["ranks"][0]["train"][name]["grads"])
    for ref in (run["single"]["port"][model][0],
                run["single"]["jax"][model][0]):
        assert len(got) == len(ref)
        for g, w in zip(got, ref):
            assert_close(g, w, 2e-5)


@pytest.mark.parametrize("name", list(dc.TRAIN))
def test_sharded_losses_match_single_device(run, name):
    model = dc.TRAIN[name][0]
    got = run["ranks"][0]["train"][name]["losses"]
    for ref in (run["single"]["port"][model][1],
                run["single"]["jax"][model][1]):
        assert np.abs(np.subtract(got, ref)).max() < 5e-3, (got, ref)


@pytest.mark.parametrize("name", list(dc.TRAIN) + list(dc.EF_TRAIN))
def test_params_stay_replicated(run, name):
    """Every rank applies the same update: its params and losses are
    rank 0's, bit for bit."""
    first = run["ranks"][0]["train"][name]
    for r in run["ranks"][1:]:
        mine = r["train"][name]
        assert mine["losses"] == first["losses"]
        for a, b in zip(tree_flatten(mine["params"]),
                        tree_flatten(first["params"])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(dc.EF_TRAIN))
def test_ef_step_losses_match_jax(run, name):
    model = dc.EF_TRAIN[name][0]
    got = run["ranks"][0]["train"][name]["losses"]
    want = run["single"]["jax_ef"][model]
    assert np.abs(np.subtract(got, want)).max() < 5e-3, (got, want)


def test_forward_on_the_mesh_matches_jax(run):
    for r in run["ranks"]:
        assert_close(r["forward"], run["jax"]["forward"], 2e-5)


def test_generate_on_the_mesh_matches_jax(run):
    for r in run["ranks"]:
        assert np.array_equal(r["generate"], run["jax"]["generate"])


# ---------------------------------------------------------------------------
# mesh=None: the one-device path
# ---------------------------------------------------------------------------

def test_mesh_none_is_the_one_device_path():
    """Without a mesh an ``a2a`` config runs moe_dense, and every model
    function gives the bits it gives without the argument."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import forward, init_params, loss_fn
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.serve import generate
    cfg = get_smoke("mixtral-8x22b").replace(moe_impl="a2a")
    p = init_params(0, cfg, "cpu")
    x, pm = dc.moe_inputs("dm-a2a-E4")
    x, pm = torch.from_numpy(x), bridge.to_torch(pm, "cpu")
    mcfg = cfg.replace(**dc.moe_overrides("dm-a2a-E4"))
    assert torch.equal(tmoe.moe_forward(x, pm, mcfg),
                       tmoe.moe_dense(x, pm, mcfg))
    toks = torch.from_numpy(dc.gen_inputs(cfg.vocab_size)[1]).long()
    b = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        assert torch.equal(forward(p, cfg, b, None), forward(p, cfg, b))
        assert torch.equal(forward(p, cfg.replace(moe_impl="dense"), b),
                           forward(p, cfg, b))
        assert torch.equal(loss_fn(p, cfg, b, None), loss_fn(p, cfg, b))
        c1, c2 = (init_cache(cfg, 4, 20, "cpu") for _ in range(2))
        l1, c1 = prefill(p, cfg, {"tokens": toks}, c1, None)
        l2, c2 = prefill(p, cfg, {"tokens": toks}, c2)
        assert torch.equal(l1, l2)
        pos = torch.full((4, 1), 16, dtype=torch.int32)
        d1 = decode_step(p, cfg, {"tokens": toks[:, :1]}, c1, pos, None)[0]
        d2 = decode_step(p, cfg, {"tokens": toks[:, :1]}, c2, pos)[0]
        assert torch.equal(d1, d2)
    assert torch.equal(generate(p, cfg, toks, 3, mesh=None).tokens,
                       generate(p, cfg, toks, 3).tokens)
