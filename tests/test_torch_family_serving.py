"""The new families through the port's launchers and Server on the CPU:
``repro_torch.launch.cure`` on the SSM, hybrid and MoE SMOKEs against the
JAX CLI on the same params and calibration batches (the same layers, DEIM
rows and columns with ``--svd exact``, parameter counts and generate
engine: the static-batch engine for mamba state, the paged Server for
attention stacks); the port's Server on the MoE and 5:1 local:global
SMOKEs against the JAX Server (the same greedy tokens and finish
reasons); and the embeddings-mode configs refused by cure and serve, as
in the JAX package."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.launch import cure as jax_cure
from repro.launch.serve import make_workload as jax_make_workload
from repro.models import init_params as jax_init_params
from repro.serving import PagedConfig as JaxPagedConfig
from repro.serving import Server as JaxServer
from repro_torch.launch import cure as tcure
from repro_torch.launch import serve as tserve
from repro_torch.serving import PagedConfig, Server
from repro_torch.serving import paged_cache

from _torch_helpers import jax_backed, port_cfg, port_params

torch.set_num_threads(1)

CURE_ARGV = ["--smoke", "--layers", "2", "--r-max", "8", "--svd", "exact"]


def _quiet(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a)
    return res, out.getvalue()


@pytest.mark.parametrize("arch,engine", [("mamba2-1.3b", "legacy"),
                                         ("jamba-v0.1-52b", "legacy"),
                                         ("mixtral-8x22b", "serving")])
def test_cure_launcher_matches_jax_cli(arch, engine, tmp_path, monkeypatch):
    infos = []
    real = jax_cure.compress_model

    def spy(*a, **kw):
        out = real(*a, **kw)
        infos.append(out[2])
        return out

    monkeypatch.setattr(jax_cure, "compress_model", spy)
    argv = ["--arch", arch] + CURE_ARGV
    jrep, _ = _quiet(jax_cure.main, argv + ["--ckpt-dir",
                                            str(tmp_path / "jax")])
    jax_backed(monkeypatch, arch, tcure)
    run, _ = _quiet(lambda a: tcure.cure_run(tcure.parser().parse_args(a)),
                    argv + ["--device", "cpu", "--ckpt-dir",
                            str(tmp_path / "port")])
    rep = run.report
    assert rep["layers_compressed"] == jrep["layers_compressed"]
    assert rep["generate"]["engine"] == jrep["generate"]["engine"] == engine
    assert rep["generate"]["tokens"] == jrep["generate"]["tokens"]
    assert rep["params"] == jrep["params"]
    assert rep["n_weights"] == jrep["n_weights"] > 0
    for tw, jw in zip(rep["weights"], jrep["weights"]):
        assert (tw["layer"], tw["name"], tuple(tw["shape"]), tw["rank"]) == \
            (jw["layer"], jw["name"], tuple(jw["shape"]), jw["rank"])
    (jinfo,) = infos
    assert len(run.info.weights) == len(jinfo.weights)
    for tw, jw in zip(run.info.weights, jinfo.weights):
        assert (tw.layer, tw.name) == (jw.layer, jw.name)
        np.testing.assert_array_equal(tw.rows, np.asarray(jw.rows))
        np.testing.assert_array_equal(tw.cols, np.asarray(jw.cols))
    # the CUR targets of the family were compressed, expert stacks not
    names = {w.name for w in run.info.weights}
    assert names <= set(run.cfg.cur_targets) and names


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-medium"])
def test_cure_and_serve_refuse_the_embeddings_stub(arch, tmp_path):
    with pytest.raises(SystemExit, match="embeddings stub"):
        tcure.cure(tcure.parser().parse_args(
            ["--arch", arch, "--smoke", "--device", "cpu", "--ckpt-dir",
             str(tmp_path)]))
    with pytest.raises(SystemExit):
        _quiet(tserve.main, ["--arch", arch, "--smoke", "--device", "cpu"])


CALIB = np.random.RandomState(1).randint(0, 256, (2, 64)).astype(np.int32)


def _serve(server_cls, params, cfg, pc, wl, calib, **kw):
    srv = server_cls(params, cfg, pc, max_concurrency=4, calib_tokens=calib,
                     **kw)
    for w in wl:
        srv.submit(w["prompt"], w["max_new_tokens"])
    srv.drain()
    return {k: (list(r.out_tokens), r.finish_reason)
            for k, r in srv.finished.items()}


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b",
                                  "gemma3-1b"])
def test_server_greedy_tokens_match_jax(arch):
    """Dense pools and CUR-KV at r = hd / 2. Mixtral's SMOKE is all-local
    (window 16), so its pool evicts blocks behind the window."""
    jcfg = jax_get_smoke(arch)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg, params = port_cfg(jcfg), port_params(jparams)
    assert paged_cache.supports(cfg)
    assert paged_cache.serving_window(cfg) == (
        16 if arch == "mixtral-8x22b" else 0)
    wl = jax_make_workload(6, jcfg.vocab_size, max_new=10)
    calib = CALIB % jcfg.vocab_size
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    hd = jcfg.resolved_head_dim
    for cur_kv, r in ((False, 0), (True, hd // 2)):
        kw = dict(block_size=4, cur_kv=cur_kv, kv_rank=r)
        jpc = JaxPagedConfig.sized_for(max_len, 4, **kw)
        pc = PagedConfig.sized_for(max_len, 4, **kw)
        want = _serve(JaxServer, jparams, jcfg, jpc, wl, jnp.asarray(calib))
        got = _serve(Server, params, cfg, pc, wl, calib, device="cpu")
        assert got == want
        assert len(got) == len(wl)


def test_cure_checkpoint_of_a_hybrid_tree_restores(tmp_path):
    """cure's save stage on jamba's SMOKE (per-layer groups, mamba and
    MoE leaves, f32 leaves beside CUR dicts): restored through its
    template.json, every leaf torch.equal."""
    from repro_torch.dist import (
        CheckpointManager, load_tree_template, tree_flatten)
    run, _ = _quiet(tcure.cure_run, tcure.parser().parse_args(
        ["--arch", "jamba-v0.1-52b"] + CURE_ARGV
        + ["--device", "cpu", "--ckpt-dir", str(tmp_path)]))
    tmpl = load_tree_template(str(tmp_path / "template.json"))
    step, tree = CheckpointManager(str(tmp_path)).restore(tmpl,
                                                          device="cpu")
    mine, ref = tree_flatten(tree["params"]), tree_flatten(run.cured_params)
    assert step == 0 and len(mine) == len(ref) > 0
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(mine, ref))
    assert {str(t.dtype) for t in mine} == {"torch.float32"}


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x22b"])
def test_plan_cli_matches_jax_on_the_same_params(arch, tmp_path,
                                                 monkeypatch):
    """The plan CLI on a hybrid / MoE SMOKE, fed the JAX run's params and
    batches: the JAX plan's layers, ranks and realized counts."""
    from repro.launch import plan as jax_plan_cli
    from repro_torch.launch import plan as tplan_cli
    argv = ["--arch", arch, "--smoke", "--budget-params", "0.5",
            "--layers", "2", "--grid", "4,8,16", "--calib-len", "16"]
    jplan, _ = _quiet(jax_plan_cli.main, argv + ["--out",
                                                 str(tmp_path / "j.json")])
    jax_backed(monkeypatch, arch, tplan_cli)
    tplan, _ = _quiet(tplan_cli.main, argv + ["--out", str(tmp_path / "t"),
                                              "--device", "cpu"])
    for f in ("layers", "ranks", "feasible", "solver", "selection"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.provenance["cfg_hash"] == jplan.provenance["cfg_hash"]
    for k in ("params_before", "params_after", "fraction"):
        assert tplan.realized[k] == jplan.realized[k], k


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "kimi-k2-1t-a32b"])
def test_train_cli_resumes_a_jax_checkpoint(arch, tmp_path, monkeypatch,
                                            capsys):
    """The JAX train CLI's step-2 checkpoint of an SSM / MoE SMOKE (f32
    leaves, expert stacks, the shared expert) resumes in the port's."""
    import sys
    from repro.launch import train as jax_train_cli
    from repro_torch.launch import train as train_cli
    base = ["--arch", arch, "--smoke", "--seq-len", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    monkeypatch.setattr(sys, "argv", ["train", *base, "--steps", "2"])
    jax_train_cli.main()
    capsys.readouterr()
    run = train_cli.run(train_cli.parser().parse_args(
        base + ["--steps", "4", "--resume", "--device", "cpu"]))
    assert "resumed from step 2" in capsys.readouterr().out
    assert run.start == 2 and int(run.opt_state["step"]) == 4
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
