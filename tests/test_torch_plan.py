"""Port parity for budget-driven planning (``repro_torch.plan``) against
the JAX package's ``repro.plan`` on the same bridged params and numpy
calibration batches, exact SVD: the sensitivity curves (2e-5,
scale-relative), DEIM's prefix consistency, the allocations of both
solvers for every budget kind (integers and the realized budget exact),
the plan JSON text, the provenance hashes, and ``progressive_cure``'s
rounds. Then the claims of ``tests/test_plan.py``, ported; the trained
model they need is a small llama-family model trained here on the CPU."""
import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.roofline.analysis as jroof
from repro import plan as jplan
from repro.configs import get_config as jax_get_config
from repro.configs import get_repro as jax_get_repro
from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import CURConfig as JaxCURConfig
from repro.core import calibrate as jax_calibrate
from repro.models import init_params as jax_init_params
from repro_torch import plan as tplan
from repro_torch.configs import get_config, get_repro, get_smoke
from repro_torch.configs.base import CURConfig, OptimizerConfig
from repro_torch.core import calibrate, compress_model
from repro_torch.core.deim import deim
from repro_torch.plan import (
    CompressionPlan, allocate, feasible_grid, plan_for_model,
    profile_sensitivity, progressive_cure)
from repro_torch.plan.allocate import PLAN_VERSION
from repro_torch.roofline import analysis as troof

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)

GRID = (4, 8, 16)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_batches(vocab, n, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append((toks[:, :-1], toks[:, 1:]))
    return out


def _jb(nb):
    return [{"tokens": jnp.asarray(t), "labels": jnp.asarray(lab)}
            for t, lab in nb]


def _tb(nb):
    return [{"tokens": torch.from_numpy(t).long(),
             "labels": torch.from_numpy(lab).long()} for t, lab in nb]


def _both(jcfg, jparams, seed=0):
    """(JAX cfg, params, calib, port cfg, params, calib) on one numpy
    calibration batch."""
    nb = _np_batches(jcfg.vocab_size, 1, seed=seed)
    tcfg, tp = port_cfg(jcfg), port_params(jparams)
    return (jcfg, jparams, jax_calibrate(jparams, jcfg, _jb(nb)),
            tcfg, tp, calibrate(tp, tcfg, _tb(nb)))


@pytest.fixture(scope="module")
def case(tiny_cfg, tiny_params):
    jcfg, jp, jcal, tcfg, tp, tcal = _both(tiny_cfg, tiny_params)
    return SimpleNamespace(
        jcfg=jcfg, jp=jp, jcal=jcal, tcfg=tcfg, tp=tp, tcal=tcal,
        jprof=jplan.profile_sensitivity(jp, jcfg, JaxCURConfig(r_max=16),
                                        jcal, grid=GRID),
        tprof=profile_sensitivity(tp, tcfg, CURConfig(r_max=16), tcal,
                                  grid=GRID))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# the profile against JAX's
# ---------------------------------------------------------------------------

def _assert_profiles_match(tprof, jprof):
    assert [c.key for c in tprof.curves] == [c.key for c in jprof.curves]
    assert tprof.grid == jprof.grid
    assert (tprof.selection, tprof.svd) == (jprof.selection, jprof.svd)
    for t, j in zip(tprof.curves, jprof.curves):
        assert (t.layer, t.name, t.shape, t.grid, t.bound_on) == \
            (j.layer, j.name, tuple(j.shape), j.grid, j.bound_on)
        assert_close(t.rel_err, j.rel_err)
        assert_close(t.func_err, j.func_err)
        fin = np.isfinite(j.bound)
        np.testing.assert_array_equal(np.isfinite(t.bound), fin)
        assert fin.any()
        assert_close(t.bound[fin], j.bound[fin])
        assert _rel(t.fro_w, j.fro_w) < 2e-5
        assert _rel(t.func_fro_w, j.func_fro_w) < 2e-5
    np.testing.assert_allclose(tprof.distances, jprof.distances,
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("model,selection", [
    ("tiny", "wanda_deim"), ("tiny", "deim"), ("smoke", "wanda_deim")])
def test_profile_matches_jax(case, model, selection):
    if model == "tiny" and selection == "wanda_deim":
        tprof, jprof = case.tprof, case.jprof
    else:
        if model == "tiny":
            c = case
        else:
            jcfg = jax_get_smoke("llama3.1-8b")
            jc, jp, jcal, tcfg, tp, tcal = _both(
                jcfg, jax_init_params(jax.random.PRNGKey(1), jcfg), seed=3)
            c = SimpleNamespace(jcfg=jc, jp=jp, jcal=jcal, tcfg=tcfg,
                                tp=tp, tcal=tcal)
        grid = (4, 8, 16, 32)
        jprof = jplan.profile_sensitivity(
            c.jp, c.jcfg, JaxCURConfig(selection=selection), c.jcal,
            grid=grid)
        tprof = profile_sensitivity(c.tp, c.tcfg,
                                    CURConfig(selection=selection), c.tcal,
                                    grid=grid)
    _assert_profiles_match(tprof, jprof)


def test_randomized_profile_draws_the_compressors_sketch(case):
    """At a one-rank grid the profile's sketch width equals the
    compressor's at that rank, and both draw it from the weight's item
    seed: the curve is then the executed error (randomized SVD)."""
    ccfg = CURConfig(r_max=16, svd="randomized", seed=3)
    prof = profile_sensitivity(case.tp, case.tcfg, ccfg, case.tcal,
                               grid=(8,))
    ranks = {c.key: 8 for c in prof.curves}
    _, _, info = compress_model(case.tp, case.tcfg,
                                dataclasses.replace(ccfg, ranks=ranks),
                                case.tcal, layers=[1, 2])
    by_key = {f"{w.layer}:{w.name}": w for w in info.weights}
    for c in prof.curves:
        w = by_key[c.key]
        assert abs(c.rel_err[0] - w.fro_err / w.fro_w) < 1e-5, c.key


@pytest.mark.parametrize("m,r_hi,batch", [
    (64, 16, ()), (200, 48, (3,)), (512, 64, (2,)), (1024, 128, ())])
def test_deim_is_prefix_consistent(m, r_hi, batch):
    """deim(P[:, :r]) == deim(P[:, :r_hi])[:r] for every r <= r_hi: step j
    reads columns <= j only (the padded solve is the identity beyond)."""
    rng = np.random.default_rng(m + r_hi)
    V = np.linalg.qr(rng.standard_normal((*batch, m, r_hi)))[0]
    V = torch.from_numpy(V.astype(np.float32))
    full = deim(V)
    assert full.shape == (*batch, r_hi)
    for r in sorted({1, 2, 3, 4, 7, 8, r_hi // 2, r_hi - 1}):
        assert torch.equal(deim(V[..., :r]), full[..., :r]), r


# ---------------------------------------------------------------------------
# the allocation against JAX's, on JAX's profile
# ---------------------------------------------------------------------------

def _port_profile(jprof):
    """JAX's SensitivityProfile as the port's (the same numbers)."""
    return tplan.SensitivityProfile(
        curves=[tplan.WeightCurve(
            layer=c.layer, name=c.name, shape=tuple(c.shape), grid=c.grid,
            rel_err=np.asarray(c.rel_err), func_err=np.asarray(c.func_err),
            bound=np.asarray(c.bound), bound_on=c.bound_on, fro_w=c.fro_w,
            func_fro_w=c.func_fro_w) for c in jprof.curves],
        grid=jprof.grid, selection=jprof.selection, svd=jprof.svd,
        seconds=jprof.seconds, cfg_hash=jprof.cfg_hash,
        calib_hash=jprof.calib_hash, distances=jprof.distances)


def _assert_plans_equal(tp, jp):
    for f in ("version", "arch", "budget_kind", "budget_requested",
              "solver", "layers", "ranks", "selection", "svd", "fold_u",
              "seed", "feasible", "realized", "provenance"):
        assert getattr(tp, f) == getattr(jp, f), f
    strip = ("solve_seconds",)
    assert {k: v for k, v in tp.predicted.items() if k not in strip} == \
        {k: v for k, v in jp.predicted.items() if k not in strip}


@pytest.mark.parametrize("solver", ["greedy", "dp"])
@pytest.mark.parametrize("kind,value,fold_u", [
    ("params", 0.5, False), ("params", 0.3, True), ("bytes", 0.5, False),
    ("latency_ms", 1.0, False), ("latency_ms", 2e-5, True),
    ("params", 8.0, False)])
def test_allocation_matches_jax(case, monkeypatch, solver, kind, value,
                                fold_u):
    # the latency budget at JAX's roofline constants (the formulas are
    # the same; the port's constants are the H100's)
    monkeypatch.setattr(troof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BW", jroof.HBM_BW)
    kw = dict(solver=solver, fold_u=fold_u, arch="tiny", seed=2)
    jp = jplan.allocate(case.jprof, kind, value, **kw)
    tp = allocate(_port_profile(case.jprof), kind, value, **kw)
    _assert_plans_equal(tp, jp)


@pytest.mark.parametrize("solver", ["greedy", "dp"])
def test_latency_budget_at_h100_constants(case, solver):
    """At the H100's constants the realized roofline ms stays within the
    request; the request is the cost of a uniform rank-8 allocation."""
    budget = sum(tplan.weight_cost(c.shape[0], c.shape[1], 8, "latency_ms",
                                   fold_u=True, dtype_bytes=4)
                 for c in case.tprof.curves)
    plan = allocate(case.tprof, "latency_ms", budget, solver=solver)
    assert plan.feasible
    assert plan.realized["latency_ms_after"] <= budget * (1 + 1e-9)
    # the realized entries are rounded to 6 decimals (of a millisecond)
    assert plan.realized["latency_ms_before"] == round(sum(
        1e3 * c.shape[0] * c.shape[1] * 4 / 3.35e12
        for c in case.tprof.curves), 6)


# ---------------------------------------------------------------------------
# the plan artifact and provenance
# ---------------------------------------------------------------------------

def test_plan_json_text_matches_jax(case):
    jp = jplan.allocate(case.jprof, "params", 0.5, arch="tiny", seed=4)
    tp = CompressionPlan(**{f.name: getattr(jp, f.name)
                            for f in dataclasses.fields(jp)})
    assert tp.to_json() == jp.to_json()
    again = CompressionPlan.from_json(jp.to_json())
    assert again.to_json() == jp.to_json()
    assert jplan.CompressionPlan.from_json(again.to_json()) == jp


@pytest.mark.parametrize("which", ["smoke:llama3.1-8b", "smoke:olmo-1b",
                                   "repro", "llama3.1-8b", "olmo-1b"])
def test_config_hash_matches_jax(which):
    if which == "repro":
        t, j = get_repro(), jax_get_repro()
    elif which.startswith("smoke:"):
        t, j = get_smoke(which[6:]), jax_get_smoke(which[6:])
    else:
        t, j = get_config(which), jax_get_config(which)
    assert repr(t) == repr(j)
    assert tplan.config_hash(t) == jplan.config_hash(j)


def test_calib_hash_matches_jax(case):
    for calib in (case.jcal, case.tcal):
        assert tplan.calib_hash(calib) == jplan.calib_hash(calib)
    assert case.tprof.calib_hash == tplan.calib_hash(case.tcal)
    assert case.tprof.cfg_hash == case.jprof.cfg_hash


def test_example_plan_loads_and_round_trips():
    path = os.path.join(ROOT, "examples", "plan_olmo_1b_smoke.json")
    plan = CompressionPlan.load(path)
    assert plan.version == PLAN_VERSION and plan.arch == "olmo-1b-smoke"
    with open(path) as f:
        assert plan.to_json() + "\n" == f.read()
    assert CompressionPlan.from_json(plan.to_json()) == plan
    assert plan.to_json() == jplan.CompressionPlan.load(path).to_json()
    ccfg = plan.to_cur_config()
    assert ccfg.ranks == plan.ranks and ccfg.enabled


# ---------------------------------------------------------------------------
# progressive_cure against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def six_layer(tiny_cfg):
    jcfg = tiny_cfg.replace(n_layers=6,
                            groups=((tiny_cfg.groups[0][0], 6),))
    return jcfg, jax_init_params(jax.random.PRNGKey(2), jcfg)


@pytest.mark.parametrize("heal_steps,max_inc", [(3, 1.0), (0, 0.0)])
def test_progressive_matches_jax(six_layer, monkeypatch, heal_steps,
                                 max_inc):
    """Three layers in two rounds: the same per-round layers, ranks and
    accept flags, the same early stop, and the same perplexities (2e-5)
    in both packages (the plans' realized latency at JAX's constants)."""
    monkeypatch.setattr(troof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BW", jroof.HBM_BW)
    jcfg, jp = six_layer
    cal = _np_batches(jcfg.vocab_size, 1, seed=1)
    evl = _np_batches(jcfg.vocab_size, 2, seed=5)
    heal = _np_batches(jcfg.vocab_size, 2 * max(heal_steps, 1), seed=7)
    kw = dict(budget_kind="params", budget_value=0.4, n_layers=3, rounds=2,
              heal_steps=heal_steps, grid=GRID, max_ppl_increase=max_inc)
    jres = jplan.progressive_cure(
        jp, jcfg, calib_batches=_jb(cal), eval_batches=_jb(evl),
        heal_batch_at=lambda i: _jb(heal)[i],
        cur_cfg=JaxCURConfig(r_max=16, fold_u=False), **kw)
    tres = progressive_cure(
        port_params(jp), port_cfg(jcfg), calib_batches=_tb(cal),
        eval_batches=_tb(evl), heal_batch_at=lambda i: _tb(heal)[i],
        cur_cfg=CURConfig(r_max=16, fold_u=False), **kw)
    assert tres.early_stopped == jres.early_stopped
    assert len(tres.rounds) == len(jres.rounds) > 0
    for t, j in zip(tres.rounds, jres.rounds):
        assert (t.round, t.layers, t.ranks, t.accepted, t.heal_steps) == \
            (j.round, j.layers, j.ranks, j.accepted, j.heal_steps)
        assert _rel(t.ppl_compressed, j.ppl_compressed) < 2e-5
        assert _rel(t.ppl, j.ppl) < 2e-5
        assert t.plan.ranks == j.plan.ranks
        assert t.plan.realized == j.plan.realized
    assert _rel(tres.ppl_initial, jres.ppl_initial) < 2e-5
    assert _rel(tres.ppl_final, jres.ppl_final) < 2e-5
    assert tres.merged_ranks == jres.merged_ranks


# ---------------------------------------------------------------------------
# tests/test_plan.py's claims, ported
# ---------------------------------------------------------------------------

def test_profile_covers_targets_and_curves_decrease(case):
    prof = case.tprof
    assert {c.layer for c in prof.curves} == set(
        range(1, case.tcfg.n_layers - 1))
    assert {c.name for c in prof.curves} == set(case.tcfg.cur_targets)
    for c in prof.curves:
        assert c.grid == feasible_grid(c.shape[0], c.shape[1], GRID)
        assert len(c.grid) >= 1
        assert all(np.diff(c.rel_err) <= 1e-6)
        assert all(np.diff(c.func_err) <= 1e-6)
        assert np.all(c.rel_err >= 0) and np.all(c.rel_err <= 1.5)
        assert c.bound_on == "wanda"
        assert np.all(c.bound[np.isfinite(c.bound)] >= 0)
    assert prof.cfg_hash and prof.calib_hash
    assert prof.distances.shape == (case.tcfg.n_layers,)
    assert set(prof.class_seconds) == {f"{m}x{n}" for m, n in
                                       {c.shape for c in prof.curves}}


def test_profile_rejects_non_deim_selection(case):
    with pytest.raises(ValueError):
        profile_sensitivity(case.tp, case.tcfg,
                            CURConfig(selection="random"), case.tcal)


@pytest.mark.parametrize("chunk_bytes", [None, 1])
def test_profiled_error_matches_executed_compression(case, monkeypatch,
                                                     chunk_bytes):
    """The curves predict what compress_model realizes (exact SVD, DEIM
    prefix consistency); ``chunk_bytes`` 1 runs every weight of a class
    in its own chunk, with the same curves."""
    prof = case.tprof
    if chunk_bytes is not None:
        from repro_torch.plan import sensitivity
        monkeypatch.setattr(sensitivity, "CHUNK_BYTES", chunk_bytes)
        prof = profile_sensitivity(case.tp, case.tcfg, CURConfig(r_max=16),
                                   case.tcal, grid=GRID)
        for a, b in zip(prof.curves, case.tprof.curves):
            np.testing.assert_array_equal(a.rel_err, b.rel_err)
    ranks = {c.key: int(c.grid[min(1, len(c.grid) - 1)])
             for c in prof.curves if c.layer in (1, 2)}
    _, _, info = compress_model(case.tp, case.tcfg,
                                CURConfig(r_max=16, ranks=ranks), case.tcal,
                                layers=[1, 2])
    by_key = {f"{w.layer}:{w.name}": w for w in info.weights}
    assert set(by_key) == set(ranks)
    for c in prof.curves:
        w = by_key[c.key]
        assert w.rank == ranks[c.key]
        predicted = float(c.rel_err[c.grid.index(w.rank)])
        realized = w.fro_err / max(w.fro_w, 1e-30)
        assert abs(predicted - realized) < 1e-4, (c.key, predicted, realized)


def test_allocate_respects_budget_and_dp_is_optimal(case):
    plans = {s: allocate(case.tprof, "params", 0.5, solver=s, fold_u=False,
                         arch="tiny") for s in ("greedy", "dp")}
    for s, plan in plans.items():
        assert plan.feasible, s
        assert (plan.realized["params_after"]
                <= plan.budget_requested * (1 + 1e-9)), s
        assert set(plan.ranks) == {c.key for c in case.tprof.curves}
    assert (plans["dp"].predicted["objective"]
            <= plans["greedy"].predicted["objective"] * (1 + 1e-9))


def test_allocate_latency_and_bytes_budgets(case):
    # 1 ms at the H100's constants is as loose a budget as at JAX's
    for solver in ("greedy", "dp"):
        for kind, value in (("bytes", 0.5), ("latency_ms", 1.0)):
            plan = allocate(case.tprof, kind, value, fold_u=False,
                            solver=solver)
            assert plan.feasible, (solver, kind)
            assert (plan.realized[f"{kind}_after"]
                    <= plan.budget_requested * (1 + 1e-9))
            assert any(plan.ranks[c.key] > c.grid[0]
                       for c in case.tprof.curves), (solver, kind)
    with pytest.raises(ValueError):
        allocate(case.tprof, "flops", 0.5)


def test_allocate_infeasible_budget_flagged(case):
    plan = allocate(case.tprof, "params", 8.0, fold_u=False)
    assert not plan.feasible
    for c in case.tprof.curves:
        assert plan.ranks[c.key] == c.grid[0]


def test_plan_json_roundtrip(case):
    plan = allocate(case.tprof, "params", 0.5, arch="tiny", fold_u=True)
    clone = CompressionPlan.from_json(plan.to_json())
    assert clone == plan
    assert clone.version == PLAN_VERSION
    bad = plan.to_json().replace(f'"version": {PLAN_VERSION}',
                                 '"version": 999')
    with pytest.raises(ValueError):
        CompressionPlan.from_json(bad)


def test_plan_to_cur_config_executes(case):
    plan = allocate(case.tprof, "params", 0.5, fold_u=False)
    ccfg = plan.to_cur_config(CURConfig(pipeline="batched"))
    _, _, info = compress_model(case.tp, case.tcfg, ccfg, case.tcal,
                                layers=plan.layers)
    assert {f"{w.layer}:{w.name}": w.rank for w in info.weights} == \
        plan.ranks
    assert (sum(w.params_after for w in info.weights)
            == plan.realized["params_after"])


def test_ranks_override_validation(case):
    with pytest.raises(ValueError, match="does not name"):
        compress_model(case.tp, case.tcfg, CURConfig(ranks={"1:nope": 4}),
                       case.tcal, layers=[1])
    with pytest.raises(ValueError, match="outside"):
        compress_model(case.tp, case.tcfg, CURConfig(ranks={"1:wk": 4096}),
                       case.tcal, layers=[1])
    with pytest.raises(ValueError, match="not being compressed"):
        compress_model(case.tp, case.tcfg, CURConfig(ranks={"2:wq": 4}),
                       case.tcal, layers=[1])


def test_ranks_map_is_the_complete_allocation(case):
    ranks = {"1:wq": 8, "1:w_gate": 8}            # omits 1:wk
    _, _, info = compress_model(case.tp, case.tcfg, CURConfig(ranks=ranks),
                                case.tcal, layers=[1])
    assert {f"{w.layer}:{w.name}" for w in info.weights} == set(ranks)


def test_progressive_skips_empty_round_chunks(case):
    batch = _tb(_np_batches(case.tcfg.vocab_size, 1))
    res = progressive_cure(
        case.tp, case.tcfg, budget_kind="params", budget_value=0.5,
        n_layers=1, rounds=2, calib_batches=batch,
        eval_batches=_tb(_np_batches(case.tcfg.vocab_size, 1, seed=5)),
        heal_steps=0, cur_cfg=CURConfig(r_max=16, fold_u=False), grid=GRID,
        max_ppl_increase=100.0)
    assert len(res.rounds) == 1 and res.rounds[0].accepted
    assert len(res.rounds[0].layers) == 1
    assert res.merged_ranks


# the trained models of the claims below: small llama-family models
# trained here on the CPU (~12-15 s each at one thread), where the REPRO
# zoo model of tests/test_plan.py would take minutes. "trained": 5
# layers, d 64, vocab 256, 300 steps; "barely_trained": 6 layers, d 128,
# vocab 512, 120 steps, on which the planned-vs-uniform claim fails in
# both packages alike (planned 384.92 vs uniform 384.84)


def _train_small(name, steps, **dims):
    from repro_torch.data.tokens import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train.train_loop import train
    n = dims["n_layers"]
    cfg = get_repro().replace(name=name, groups=(
        (get_repro().groups[0][0], n),), **dims)
    jcfg = jax_get_repro().replace(name=name, groups=(
        (jax_get_repro().groups[0][0], n),), **dims)
    dc = DataConfig(vocab_size=dims["vocab_size"], seq_len=64,
                    global_batch=8, seed=0)
    ds = SyntheticLM(dc, "cpu")
    params, _, _ = train(init_params(0, cfg, "cpu"), cfg, OptimizerConfig(
        lr=3e-3, warmup_steps=10, total_steps=steps),
        (ds.batch_at(i) for i in range(steps)))
    evalb = [ds.batch_at(10_000 + i) for i in range(2)]
    cds = SyntheticLM(dataclasses.replace(dc, seed=1), "cpu")
    calib = calibrate(params, cfg, [cds.batch_at(0)])
    return SimpleNamespace(params=params, cfg=cfg, calib=calib, evalb=evalb,
                           calib_batch=cds.batch_at(0), jcfg=jcfg)


@pytest.fixture(scope="module")
def trained():
    from repro_torch.train.evaluate import perplexity
    t = _train_small("plan-test-trained", 300, d_model=64, n_layers=5,
                     n_heads=4, n_kv_heads=2, head_dim=16, d_ff=176,
                     vocab_size=256)
    assert perplexity(t.params, t.cfg, t.evalb) < 0.8 * t.cfg.vocab_size
    return t


@pytest.fixture(scope="module")
def barely_trained():
    return _train_small("plan-test-barely", 120, d_model=128, n_layers=6,
                        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=352,
                        vocab_size=512)


def _planned_and_uniform(t, jax_side):
    """(uniform ppl, planned ppl, plan ranks) at r_max 16 uniform against
    a plan on the grid 4 .. 32 at its params, in the port or in JAX (the
    same params, bridged, and the same token batches)."""
    if jax_side:
        from repro.core import compress_model as jcompress
        from repro.train.evaluate import perplexity as jppl
        from repro_torch import bridge
        p = jax.tree.map(jnp.asarray, bridge.to_numpy(t.params))
        jb = lambda b: {k: jnp.asarray(v.numpy().astype(np.int32))  # noqa
                        for k, v in b.items()}
        cfg, calib, evalb = t.jcfg, jax_calibrate(
            p, t.jcfg, [jb(t.calib_batch)]), [jb(b) for b in t.evalb]
        compress, ppl, pfm, CC = (jcompress, jppl, jplan.plan_for_model,
                                  JaxCURConfig)
    else:
        from repro_torch.train.evaluate import perplexity as ppl
        p, cfg, calib, evalb = t.params, t.cfg, t.calib, t.evalb
        compress, pfm, CC = compress_model, plan_for_model, CURConfig
    up, ucfg, uinfo = compress(p, cfg, CC(r_max=16, n_compress_layers=3),
                               calib)
    ppl_u = ppl(up, ucfg, evalb)
    budget = sum(w.params_after for w in uinfo.weights)
    plan, _ = pfm(p, cfg, CC(r_max=32, n_compress_layers=3), calib,
                  budget_kind="params", budget_value=budget, n_layers=3,
                  grid=(4, 6, 8, 12, 16, 24, 32), solver="greedy",
                  arch=cfg.name)
    assert plan.feasible
    pp, pcfg, pinfo = compress(p, cfg, plan.to_cur_config(), calib,
                               layers=plan.layers)
    assert sum(w.params_after for w in pinfo.weights) <= budget
    assert len(set(plan.ranks.values())) > 1    # else the claim is vacuous
    return ppl_u, ppl(pp, pcfg, evalb), plan.ranks


@pytest.mark.parametrize("model,claim", [("trained", True),
                                         ("barely_trained", False)])
def test_planned_matches_or_beats_uniform_at_equal_params(model, claim,
                                                          request):
    """tests/test_plan.py's claim (planned ppl <= uniform at the uniform
    allocation's params), held where JAX's own planner holds it: both
    perplexities and the plan's ranks equal JAX's on the same params, and
    the claim's verdict is JAX's."""
    t = request.getfixturevalue(model)
    ppl_u, ppl_p, ranks = _planned_and_uniform(t, jax_side=False)
    jppl_u, jppl_p, jranks = _planned_and_uniform(t, jax_side=True)
    assert ranks == jranks
    assert _rel(ppl_u, jppl_u) < 2e-5, (ppl_u, jppl_u)
    assert _rel(ppl_p, jppl_p) < 2e-5, (ppl_p, jppl_p)
    assert (jppl_p <= jppl_u + 1e-3) == claim, (jppl_p, jppl_u)
    assert (ppl_p <= ppl_u + 1e-3) == claim, (ppl_p, ppl_u)


def test_progressive_early_stops_on_no_gain_round(trained):
    t = trained
    res = progressive_cure(
        t.params, t.cfg, budget_kind="params", budget_value=0.3, n_layers=2,
        rounds=2, calib_batches=[t.calib_batch], eval_batches=t.evalb,
        heal_steps=0, cur_cfg=CURConfig(r_max=32, fold_u=False),
        grid=(4, 8, 16, 32), max_ppl_increase=0.0)
    assert res.early_stopped
    assert len(res.rounds) == 1 and not res.rounds[0].accepted
    assert res.ppl_final == res.ppl_initial
    assert res.merged_ranks == {}
    assert res.rounds[0].ranks


def test_progressive_rejects_fold_and_absolute_budget(trained):
    t = trained
    with pytest.raises(ValueError, match="unfolded"):
        progressive_cure(t.params, t.cfg, budget_kind="params",
                         budget_value=0.3, n_layers=1, rounds=1,
                         calib_batches=[], eval_batches=t.evalb,
                         cur_cfg=CURConfig(fold_u=True))
    with pytest.raises(ValueError, match="fractional"):
        progressive_cure(t.params, t.cfg, budget_kind="params",
                         budget_value=5000.0, n_layers=1, rounds=1,
                         calib_batches=[], eval_batches=t.evalb,
                         cur_cfg=CURConfig(fold_u=False))
