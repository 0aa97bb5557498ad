"""The planning path through the port's launchers: cure ``--budget-*`` /
``--emit-plan`` / ``--plan`` / ``--emit-draft`` / ``--obs`` / ``--trace`` /
``--prof`` and the plan CLI (``repro_torch.launch.plan``), on the CPU.
A plan emitted by the JAX package's cure executes in the port's cure with
the JAX run's layers, ranks and DEIM indices (the port's cure is given the
JAX run's params and calibration batches)."""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.launch import cure as jax_cure
from repro.launch import plan as jax_plan_cli
from repro_torch import obs
from repro_torch.launch import cure as tcure
from repro_torch.launch import plan as tplan_cli
from repro_torch.plan import CompressionPlan

from _torch_helpers import jax_backed

torch.set_num_threads(1)

SMOKE = ["--arch", "llama3.1-8b", "--smoke", "--layers", "1",
         "--calib-batches", "1", "--calib-len", "16", "--device", "cpu"]


def _quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    return res, out.getvalue()


def _run(tmp_path, *extra):
    args = tcure.parser().parse_args(
        SMOKE + ["--ckpt-dir", str(tmp_path / "ck")] + list(extra))
    return tcure.cure_run(args)


def _indices(info):
    return {f"{w.layer}:{w.name}": (w.rank, w.rows.tolist(), w.cols.tolist())
            for w in info.weights}


@pytest.fixture
def clean_obs():
    """The process-wide registry off and empty before and after the test."""
    obs.disable()
    obs.default_registry().reset()
    yield obs.default_registry()
    obs.disable()
    obs.default_registry().reset()


@pytest.mark.parametrize("svd", ["randomized", "exact"])
def test_cure_budget_emit_plan_then_plan_reproduces(tmp_path, svd):
    path = str(tmp_path / "plan.json")
    first = _run(tmp_path, "--budget-params", "0.3", "--grid", "4,8,16",
                 "--emit-plan", path, "--svd", svd)
    plan = CompressionPlan.load(path)
    rep = first.report["plan"]
    assert rep["source"] == "budget" and rep["solver"] == "greedy"
    assert rep["ranks"] == plan.ranks
    assert len(set(plan.ranks.values())) > 1
    assert rep["budget"]["feasible"] and rep["budget"]["realized"] == \
        plan.realized
    assert plan.provenance["grid"] == [4, 8, 16] and plan.svd == svd
    again = _run(tmp_path, "--plan", path)
    assert again.report["plan"]["source"] == "file"
    assert again.report["layers_compressed"] == plan.layers
    assert _indices(again.info) == _indices(first.info)


def _jax_backed(monkeypatch, arch):
    jax_backed(monkeypatch, arch, tcure, tplan_cli)


def test_jax_plan_executes_in_port_cure(tmp_path, monkeypatch):
    """JAX cure --budget-params --emit-plan, then --plan in both packages
    on the same params and batches: the same layers, ranks and DEIM rows
    and columns."""
    argv = ["--arch", "olmo-1b", "--smoke", "--layers", "2",
            "--calib-batches", "1", "--calib-len", "16", "--svd", "exact"]
    path = str(tmp_path / "jax_plan.json")
    _quiet(jax_cure.main, argv + ["--budget-params", "0.3", "--grid",
                                  "4,8,16", "--emit-plan", path,
                                  "--ckpt-dir", str(tmp_path / "j0")])
    infos = []
    real = jax_cure.compress_model

    def spy(*a, **kw):
        out = real(*a, **kw)
        infos.append(out[2])
        return out

    monkeypatch.setattr(jax_cure, "compress_model", spy)
    jrep, _ = _quiet(jax_cure.main, argv[:-2] + [
        "--plan", path, "--ckpt-dir", str(tmp_path / "j1")])
    _jax_backed(monkeypatch, "olmo-1b")
    run, out = _quiet(lambda a: tcure.cure_run(tcure.parser().parse_args(a)),
                      argv[:-2] + ["--plan", path, "--device", "cpu",
                                   "--ckpt-dir", str(tmp_path / "t1")])
    assert "WARNING" not in out
    plan = CompressionPlan.load(path)
    assert run.report["layers_compressed"] == jrep["layers_compressed"] == \
        plan.layers
    assert run.report["plan"]["ranks"] == jrep["plan"]["ranks"] == plan.ranks
    assert len(set(plan.ranks.values())) > 1
    jidx = {f"{w.layer}:{w.name}": (w.rank, np.asarray(w.rows).tolist(),
                                    np.asarray(w.cols).tolist())
            for w in infos[0].weights}
    assert _indices(run.info) == jidx
    assert run.report["params"]["after_deployed"] == \
        jrep["params"]["after_deployed"]


def test_plan_cli_matches_jax_on_the_same_params(tmp_path, monkeypatch):
    argv = ["--arch", "olmo-1b", "--smoke", "--budget-params", "0.5",
            "--layers", "2", "--grid", "4,8,16", "--calib-len", "16"]
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jplan, _ = _quiet(jax_plan_cli.main, argv + ["--out", jpath])
    _jax_backed(monkeypatch, "olmo-1b")
    tplan, out = _quiet(tplan_cli.main,
                        argv + ["--out", tpath, "--device", "cpu"])
    assert "planned olmo-1b-smoke on cpu" in out
    saved = CompressionPlan.load(tpath)
    assert saved == tplan
    for f in ("layers", "ranks", "budget_requested", "feasible", "solver",
              "selection", "svd", "fold_u", "seed"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.provenance["cfg_hash"] == jplan.provenance["cfg_hash"]
    for k in ("params_before", "params_after", "bytes_before",
              "bytes_after", "fraction"):
        assert tplan.realized[k] == jplan.realized[k], k


def test_plan_cli_then_cure_plan_gives_the_same_ranks(tmp_path):
    path = str(tmp_path / "p.json")
    plan, _ = _quiet(tplan_cli.main, [
        "--arch", "llama3.1-8b", "--smoke", "--budget-params", "0.4",
        "--layers", "1", "--calib-len", "16", "--device", "cpu",
        "--out", path, "--solver", "dp"])
    run = _run(tmp_path, "--plan", path)
    assert run.report["plan"]["ranks"] == plan.ranks
    assert run.report["plan"]["solver"] == "dp"
    assert run.report["plan"]["budget"]["realized_fraction"] == \
        plan.realized["fraction"]


def test_cure_latency_and_bytes_budgets(tmp_path):
    for flag, value in (("--budget-bytes", "0.5"),
                        ("--budget-latency-ms", "1e-4")):
        rep = _run(tmp_path, flag, value, "--grid", "4,8,16",
                   "--solver", "dp").report
        b = rep["plan"]["budget"]
        assert rep["plan"]["source"] == "budget" and b["feasible"]
        kind = flag[len("--budget-"):].replace("-", "_")
        assert b["kind"] == kind
        assert b["realized"][f"{kind}_after"] <= b["requested"] * (1 + 1e-9)


def test_cure_rejects_more_than_one_plan_source(tmp_path):
    with pytest.raises(SystemExit):
        _run(tmp_path, "--plan", "p.json", "--budget-params", "0.5")
    with pytest.raises(SystemExit):
        _run(tmp_path, "--budget-params", "0.5", "--budget-bytes", "0.5")
    with pytest.raises(SystemExit):
        tplan_cli.main(["--arch", "llama3.1-8b", "--smoke",
                        "--device", "cpu"])


def test_cure_plan_of_another_config_warns(tmp_path):
    path = str(tmp_path / "p.json")
    _run(tmp_path, "--budget-params", "0.5", "--grid", "4,8",
         "--emit-plan", path)
    plan = CompressionPlan.load(path)
    plan.provenance["cfg_hash"] = "0" * 16
    plan.save(path)
    run, out = _quiet(lambda a: tcure.cure_run(tcure.parser().parse_args(a)),
                      SMOKE + ["--plan", path,
                               "--ckpt-dir", str(tmp_path / "ck")])
    assert "WARNING" in out and "cfg_hash mismatch" in out
    assert run.report["plan"]["ranks"] == plan.ranks


def test_cure_emit_draft_serves_as_a_draft(tmp_path):
    """--emit-draft saves <ckpt-dir>/draft (its plan.json beside it) with
    the JAX report's draft keys, and serve --draft DIR speculates with
    it; its budget binds: the draft is smaller than the target's CUR."""
    from repro_torch.launch import serve as tserve
    ck = tmp_path / "ck"
    run = _run(tmp_path, "--emit-draft", "--r-max", "32",
               "--draft-budget-params", "0.15", "--grid", "4,8,16,32")
    d = run.report["draft"]
    assert set(d) == {"ckpt_dir", "budget_params", "layers_compressed",
                      "ranks", "params_deployed", "realized_fraction",
                      "model_params_saved"}
    assert d["ckpt_dir"] == str(ck / "draft") and d["budget_params"] == 0.15
    plan = CompressionPlan.load(str(ck / "draft" / "plan.json"))
    assert plan.ranks == d["ranks"] and plan.feasible
    assert d["realized_fraction"] <= 0.15
    assert d["params_deployed"] < run.report["params"]["after_deployed"]
    assert "draft" in run.report["stages_s"]
    stats, out = _quiet(tserve.main, [
        "--arch", "llama3.1-8b", "--smoke", "--n-requests", "4",
        "--new-tokens", "6", "--device", "cpu", "--draft",
        str(ck / "draft"), "--spec-k", "3"])
    assert f"draft checkpoint {ck / 'draft'} (step 0)" in out
    assert stats["completed"] == 4 and stats["n_spec_windows"] > 0


def test_cure_report_draft_keys_match_jax(tmp_path):
    argv = ["--arch", "olmo-1b", "--smoke", "--layers", "2",
            "--calib-batches", "1", "--calib-len", "16", "--emit-draft"]
    jrep, _ = _quiet(jax_cure.main, argv + ["--ckpt-dir",
                                            str(tmp_path / "j")])
    trep = tcure.cure(tcure.parser().parse_args(
        argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "t")]))
    assert set(trep["draft"]) == set(jrep["draft"])
    assert set(trep["plan"]) == set(jrep["plan"])
    assert list(trep["stages_s"]) == list(jrep["stages_s"])
    assert set(trep) - {"n_layers", "device"} == set(jrep)


@pytest.mark.parametrize("pipeline,per_weight", [
    ("batched", "repro_compress_class_s"),
    ("loop", "repro_compress_weight_s")])
def test_cure_obs_writes_the_compress_metrics(tmp_path, clean_obs,
                                              pipeline, per_weight):
    out_dir = tmp_path / "obs"
    _quiet(tcure.main, SMOKE + ["--ckpt-dir", str(tmp_path / "ck"), "--obs",
                                "--obs-out", str(out_dir), "--pipeline",
                                pipeline, "--calib-batches", "2"])
    with open(out_dir / "metrics.json") as f:
        snap = json.load(f)
    for name in ("repro_compress_calibrate_batch_s",
                 "repro_compress_calibrate_time_s_total",
                 "repro_compress_calibrate_tokens_total",
                 "repro_compress_time_s_total",
                 "repro_compress_fold_time_s_total",
                 "repro_compress_weights_total", per_weight):
        assert name in snap, name
    assert snap["repro_compress_calibrate_batch_s"]["count"] == 2
    assert snap["repro_compress_calibrate_tokens_total"]["value"] == \
        2 * 2 * 16
    assert snap["repro_compress_weights_total"]["value"] == 3
    with open(out_dir / "metrics.prom") as f:
        assert "repro_compress_time_s_total" in f.read()
    if pipeline == "batched":
        assert set(snap[per_weight]["children"]) == {
            "shape=64x64r16", "shape=64x32r16", "shape=64x160r32"}


def test_calibrate_adds_no_sync_with_obs_off(monkeypatch, clean_obs):
    """With obs off the calibration pass records nothing and never
    synchronises the device (a CPU pass must not call into CUDA)."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import calibrate
    from repro_torch.models import init_params
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    cfg = get_smoke("llama3.1-8b")
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    calibrate(init_params(0, cfg, "cpu"), cfg,
              [{"tokens": toks, "labels": toks}])
    assert calls == [] and obs.default_registry().names() == []


def test_cure_trace_writes_the_stage_spans(tmp_path):
    out_dir = tmp_path / "obs"
    rep, _ = _quiet(tcure.main, SMOKE + [
        "--ckpt-dir", str(tmp_path / "ck"), "--trace", "--obs-out",
        str(out_dir)])
    with open(out_dir / "trace.json") as f:
        ev = json.load(f)["traceEvents"]
    spans = [e["name"] for e in ev if e["ph"] == "X" and e["tid"] == 0]
    assert spans == ["init", "calibrate", "plan", "compress", "fold",
                     "save", "generate"]
    assert not os.path.exists(out_dir / "metrics.json")
    assert list(rep["stages_s"]) == spans + ["total"]
    # the compression's own spans, on a lane of their own
    inner = {e["name"] for e in ev if e["ph"] == "X" and e["tid"] != 0}
    assert inner == {"cur.compress", "cur.class", "cur.wanda", "cur.svd",
                     "cur.deim", "cur.link", "cur.error", "cur.readback",
                     "cur.fold"}
    assert {"ph": "M", "pid": 0, "tid": 1, "name": "thread_name",
            "args": {"name": "cur"}} in ev


def test_cure_prof_captures_calibrate_and_compress(tmp_path):
    out_dir = tmp_path / "obs"
    _quiet(tcure.main, SMOKE + ["--ckpt-dir", str(tmp_path / "ck"),
                                "--prof", "--obs-out", str(out_dir)])
    files = sorted(os.listdir(out_dir / "torchprof"))
    assert files == ["calibrate.0.trace.json", "compress.1.trace.json"]
    with open(out_dir / "torchprof" / files[1]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"cur.compress", "cur.svd", "cur.deim", "cur.fold"} <= names


def test_plan_cli_progressive_writes_the_last_accepted_plan(tmp_path,
                                                           clean_obs):
    path = str(tmp_path / "prog.json")
    res, out = _quiet(tplan_cli.main, [
        "--arch", "olmo-1b", "--smoke", "--budget-params", "0.5",
        "--layers", "1", "--calib-len", "16", "--device", "cpu",
        "--grid", "4,8", "--progressive", "--rounds", "2", "--heal-steps",
        "2", "--max-ppl-increase", "100", "--out", path, "--obs",
        "--trace", "--obs-out", str(tmp_path / "obs")])
    assert "progressive: ppl" in out
    # one layer over two rounds: round 0's chunk is empty
    assert len(res.rounds) == 1 and res.rounds[0].accepted
    assert res.rounds[0].round == 1
    assert CompressionPlan.load(path) == res.rounds[0].plan
    with open(tmp_path / "obs" / "metrics.json") as f:
        snap = json.load(f)
    assert snap["repro_plan_rounds_total"]["value"] == 1
    assert set(snap["repro_plan_round_ppl_healed"]["children"]) == {
        "round=1"}
    with open(tmp_path / "obs" / "trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"round", "calibrate", "profile_allocate", "compress",
            "heal"} <= names
