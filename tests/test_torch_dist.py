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
  - an elastic recovery mesh over the healthy ranks;
  - the mesh step's global masked mean: masked, ragged and micro-batched
    batches (micro-batches of the global batch, one that does not divide
    over the batch axes) give JAX's GSPMD loss and gradients within 2e-5;
  - placed train steps (each rank holds its shards: Megatron TP, FSDP,
    the a2a and TP MoE bodies, CUR factors column- and row-parallel, int8
    moments, GQA heads cut by the shard): every rank's param and moment
    shards after two steps within 2e-5 of the slices of JAX's device at
    the same mesh position, the losses within JAX's 5e-3; the bytes a
    rank keeps are its shards' and no more;
  - a q8 row scale over a sharded last dim: JAX's codes exactly;
  - CheckpointManager.restore(shardings=): each rank's blocks equal JAX's
    device shards bit for bit;
  - perplexity and token accuracy on placed params equal the one-device
    values;
  - placed serving (llama, mamba2 and mixtral SMOKEs on the 2 x 4 and
    4 x 2 meshes, and the head_dim / cache-length / gathered-heads
    fallbacks): the engine's prefill + 3 greedy decode steps on a cache
    placed per cache_pspecs, the paged runtime's prefill + 3 decode steps
    + a verify window on a pool placed per paged_cache_pspecs (the
    kernel's layout and the einsum specs'): logits within 2e-5 of JAX's
    jit(in_shardings=...) steps, greedy and emitted tokens equal, and
    each rank's cache and pool shards within 2e-5 of JAX's device slice
    at its mesh position.
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
from repro.dist.checkpoint import CheckpointManager as JaxManager
from repro.dist.compression import init_residuals as jax_init_residuals
from repro.models import init_params as jax_init_params
from repro.models import moe as jmoe
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import _q8 as jax_q8
from repro.optim.adamw import _q8_sqrt as jax_q8_sqrt
from repro.train import train_loop as jloop
from repro_torch import bridge
from repro_torch.configs.base import OptimizerConfig
from repro_torch.dist import tree_flatten
from repro_torch.models import moe as tmoe
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_loop as tloop

import _dist_cases as dc
from _torch_helpers import assert_close, port_cfg, rel_err

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "src")


def _cfg(model):
    arch, over = dc.model_args(model)
    return jax_get_smoke(arch).replace(**over)


def _placed_inputs(params):
    """Each placed (and gradient-case) model's params (numpy) and
    PLACED_STEPS batches."""
    out = {}
    models = [c[0] for c in dc.PLACED.values()] + [
        c[4] for c in dc.MASKED.values()]
    for model in models:
        if model in out:
            continue
        if model == "cur":
            out[model] = dc.cur_params(params["olmo"])
        elif model in params:
            out[model] = params[model]
        else:
            out[model] = jax.device_get(jax_init_params(
                jax.random.PRNGKey(9), _cfg(model)))
    batches = {m: dc.train_batches(_cfg(m).vocab_size, 7)[:dc.PLACED_STEPS]
               for m in out}
    return out, batches


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
           "gen_params": params[dc.GEN["model"]],
           "ckpt_dir": str(tmp / "ckpt")}
    inp["grad_params"], inp["placed_batches"] = _placed_inputs(params)
    inp["serve_params"] = {
        m: jax.device_get(jax_init_params(jax.random.PRNGKey(40 + i),
                                          _cfg(m)))
        for i, m in enumerate(dc.SERVE_MODELS)}
    inp["placed_params"] = inp["grad_params"]
    whole = jax.tree.map(jnp.asarray, params[dc.RESTORE[0]])
    JaxManager(inp["ckpt_dir"]).save(0, {
        "f32": whole, "bf16": jax.tree.map(
            lambda a: a.astype(jnp.bfloat16), whole)})
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


def test_funnels_take_non_contiguous_operands(run):
    """A transposed block through all_gather_cat and all_to_all over
    'model' on the 2 x 4 mesh (rank = data * 4 + model): the model group's
    blocks in order, and row j of the swap from model rank j; the record
    notes each call's operand bytes once."""
    n_model = dc.MESHES["dm"][0][1]
    for r, res in enumerate(run["ranks"]):
        d, m = divmod(r, n_model)
        xs = [(np.arange(24, dtype=np.float32).reshape(6, 4)
               + 100 * (d * n_model + j)).T for j in range(n_model)]
        got = res["funnels"]
        assert np.array_equal(got["gather"], np.concatenate(xs, 0)), r
        assert np.array_equal(got["a2a"],
                              np.stack([x[m] for x in xs])), r
        assert got["record"] == {
            "all-gather": 96, "all-reduce": 0, "reduce-scatter": 0,
            "all-to-all": 96, "collective-permute": 0, "count": 2,
            "total": 192}, r


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


# ---------------------------------------------------------------------------
# the global masked mean, placed steps, sharded quantizers and restores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(dc.MASKED))
def test_masked_loss_and_grads_match_jax(run, name):
    """Global masked mean over global micro-batches: loss and every
    gradient within 2e-5 of JAX's GSPMD grads function, on every rank. A
    leaf whose gradient JAX's own GSPMD and one-device steps give 2e-5 or
    more apart (jamba's A_log: 8 entries, each a sum over every token and
    channel that nearly cancels, 2.8e-5) is held to twice that gap."""
    jl, jg, gap, paths = run["jax"]["repair"][name]
    for r in run["ranks"]:
        l, g = r["repair"][name]
        assert abs(l - jl) <= 2e-5 * abs(jl), (l, jl)
        got = tree_flatten(g)
        assert len(got) == len(jg)
        for a, b, own, path in zip(got, jg, gap, paths):
            err = rel_err(a, b)
            assert err < max(2e-5, 2 * own), (path, err, own)


def _want(j, i):
    """JAX's leaves sliced to the device at mesh position ``i``."""
    return [full[tuple(slice(lo, hi) for lo, hi in sl[i])]
            for full, sl in zip(j["leaves"], j["slices"])]


def _close_after_steps(a, b, where):
    """A shard after PLACED_STEPS AdamW steps against JAX's.

    Params: at least 99.5% of the entries within 2e-5 of the leaf's scale
    plus 5% of Adam's largest move over the steps (lr a step), and every
    one within that scale term plus the whole move. Adam divides each
    moment by the root of its square, so an entry whose gradients nearly
    cancel over the steps moves by a different fraction of lr on a change
    in the gradient's last bits (JAX's own placed step departs from its
    one-device step by up to 1.5% of the move, on olmo's embedding with 2
    kv heads; a top-k near-tie in a MoE router moves more), and a
    zero-initialized bias is all such moves; a wrong gradient moves most
    entries by O(lr). f32 moments, linear in the
    gradients: at least 99.5% of the entries within 2e-5 of scale and
    every one within 1e-4 (the second step's gradients are taken at the
    params the first one moved). int8 moments: codes within one of JAX's
    and at most 1% of them off, row scales within one code (1/127) of
    JAX's: a code rounds x / rowmax * 127, gradients that differ in their
    last bits move the rare value at a rounding boundary, and the next
    step carries the flip. The quantizer gives JAX's codes exactly on
    equal input (test_sharded_q8_matches_jax)."""
    path = where[-1]
    if b.dtype == np.int8:
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 1, where
        assert (diff > 0).mean() <= 1e-2, (where, (diff > 0).mean())
        return
    err = np.abs(a - b)
    scale = np.abs(b).max() + 1e-9
    if path.startswith("['params']"):
        move = dc.OPT["lr"] * dc.PLACED_STEPS
        off = (err > 2e-5 * scale + 0.05 * move).mean()
        assert off <= 5e-3, (where, off, err.max())
        assert err.max() <= 2e-5 * scale + move, (where, err.max())
    elif path.endswith("['m_s']") or path.endswith("['v_s']"):
        assert err.max() <= scale / 127, (where, err.max() / scale)
    else:
        off = (err > 2e-5 * scale).mean()
        assert off <= 5e-3, (where, off, err.max() / scale)
        assert err.max() <= 1e-4 * scale, (where, err.max() / scale)


@pytest.mark.parametrize("name", list(dc.PLACED))
def test_placed_step_shards_match_jax(run, name):
    """Every rank's param and moment shards after two placed steps are
    the slices of JAX's device at its mesh position, as
    ``_close_after_steps`` holds them."""
    j = run["jax"]["placed"][name]
    for i, r in enumerate(run["ranks"]):
        got = r["placed"][name]["leaves"]
        want = _want(j, i)
        assert len(got) == len(want)
        for k, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape, (a.shape, b.shape)
            _close_after_steps(a, b, (name, i, j["paths"][k]))


@pytest.mark.parametrize("name", list(dc.PLACED))
def test_placed_step_losses_match_jax(run, name):
    want = run["jax"]["placed"][name]["losses"]
    for r in run["ranks"]:
        got = r["placed"][name]["losses"]
        assert np.abs(np.subtract(got, want)).max() < 5e-3, (got, want)


def test_no_rank_holds_a_whole_sharded_leaf(run):
    """The tensors a rank's placed step keeps (params and moments), in
    bytes, are exactly its shards per the specs: less than a whole copy."""
    j = run["jax"]["placed"][dc.BYTES_CASE]
    whole = sum(a.nbytes for a in j["leaves"])
    for i, r in enumerate(run["ranks"]):
        want = sum(a.nbytes for a in _want(j, i))
        assert r["placed"][dc.BYTES_CASE]["bytes"] == want
        assert want < whole


def test_sharded_q8_matches_jax(run):
    """int8 codes and row scales of a block whose row is split over
    'model': exactly those of JAX's quantizer on the whole tensor."""
    x = jnp.asarray(dc.q8_inputs())
    whole = [np.asarray(a) for a in jax_q8(x) + jax_q8_sqrt(x * x)]
    rows, cols = 6 // 2, 64 // 4
    for i, r in enumerate(run["ranks"]):
        d, m = divmod(i, 4)
        rs, cs = slice(d * rows, (d + 1) * rows), slice(m * cols,
                                                        (m + 1) * cols)
        for got, want in zip(r["q8"], whole):
            want = want[rs, cs] if want.ndim == 2 else want[rs]
            assert np.array_equal(got, want)


def test_restore_into_placement_matches_jax(run):
    """restore(shardings=) on each rank equals JAX's device shard at the
    same mesh position, bit for bit (f32 and bf16 leaves)."""
    want = run["jax"]["restore"]
    for i, r in enumerate(run["ranks"]):
        assert len(r["restore"]) == len(want)
        for a, b in zip(r["restore"], want):
            assert a.shape == b[i].shape
            assert np.array_equal(a, b[i])


def test_evaluate_on_placed_params(run):
    """perplexity and token accuracy on each rank's placed shards (the
    vocab-parallel loss, logits gathered for the argmax) equal those of
    the whole params without a mesh: 2e-5 and exactly."""
    for r in run["ranks"]:
        (ppl, acc), (ppl1, acc1) = r["evaluate"]["placed"], \
            r["evaluate"]["whole"]
        assert abs(ppl - ppl1) <= 2e-5 * ppl1, (ppl, ppl1)
        assert acc == acc1


# ---------------------------------------------------------------------------
# placed serving: the engine and the paged runtime on placed caches
# ---------------------------------------------------------------------------

def _shards_close(got, j, i, tol=2e-5):
    """This rank's leaves against the slices of JAX's device at mesh
    position ``i``."""
    want = _want({"leaves": j[0], "slices": j[1]}, i)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.dtype.kind in "iub":
            assert np.array_equal(a, b)
        else:
            assert_close(a, b, tol)


@pytest.mark.parametrize("name", list(dc.SERVE))
def test_placed_engine_matches_jax(run, name):
    """prefill + greedy decode steps on placed params and cache: the
    global logits on every rank within 2e-5 of JAX's, the tokens equal."""
    j = run["jax"]["serve"][name]["dense"]
    for r in run["ranks"]:
        got = r["serve"][name]["dense"]
        for a, b in zip(got["logits"], j["logits"]):
            assert_close(a, b, 2e-5)
        for a, b in zip(got["tokens"], j["tokens"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(dc.SERVE))
def test_placed_cache_shards_match_jax(run, name):
    j = run["jax"]["serve"][name]["dense"]
    for i, r in enumerate(run["ranks"]):
        _shards_close(r["serve"][name]["dense"]["cache"],
                      (j["cache"], j["slices"]), i)


_PAGED = [n for n, c in dc.SERVE.items() if c[2] is not None]


@pytest.mark.parametrize("name", _PAGED)
def test_placed_paged_steps_match_jax(run, name):
    """The paged prefill, decode steps and greedy verify window on a
    placed pool: logits within 2e-5, greedy and emitted tokens equal."""
    j = run["jax"]["serve"][name]["paged"]
    for r in run["ranks"]:
        got = r["serve"][name]["paged"]
        for a, b in zip(got["logits"], j["logits"]):
            assert_close(a, b, 2e-5)
        for a, b in zip(got["tokens"], j["tokens"]):
            assert np.array_equal(a, b)
        n = got["n_emit"]
        assert np.array_equal(n, j["n_emit"])
        for row, k in enumerate(n):
            assert np.array_equal(got["emitted"][row, :k],
                                  j["emitted"][row, :k])


@pytest.mark.parametrize("name", _PAGED)
def test_placed_pool_shards_match_jax(run, name):
    j = run["jax"]["serve"][name]["paged"]
    for i, r in enumerate(run["ranks"]):
        _shards_close(r["serve"][name]["paged"]["pool"],
                      (j["pool"], j["slices"]), i)
