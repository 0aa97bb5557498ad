"""Whole-slice parity: init -> calibrate -> WANDA x DEIM CUR (exact SVD)
-> fold -> folded forward -> perplexity, on the same bridged params and
numpy calibration batches in the JAX package and the port. Integer outputs
(selected layers, every weight's row and column indices) must be equal;
floats are held to 2e-5 scale-relative."""
import contextlib
import io
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import CURConfig as JaxCURConfig
from repro.core import calibrate as jax_calibrate
from repro.core import compress_model as jax_compress_model
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.train.evaluate import perplexity as jax_perplexity
from repro.train.evaluate import token_accuracy as jax_token_accuracy
from repro_torch.configs.base import CURConfig
from repro_torch.dist.checkpoint import tree_flatten
from repro_torch.core import calibrate, compress_model
from repro_torch.launch import cure as tcure
from repro_torch.models import forward
from repro_torch.train.evaluate import perplexity, token_accuracy

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)


def _batches(cfg, n, B, S, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out.append((toks[:, :-1], toks[:, 1:]))
    jb = [{"tokens": jnp.asarray(t), "labels": jnp.asarray(lab)}
          for t, lab in out]
    tb = [{"tokens": torch.from_numpy(t).long(),
           "labels": torch.from_numpy(lab).long()} for t, lab in out]
    return jb, tb


def _leaf(params, layer, name):
    return params["groups"][layer][0][name]


@pytest.fixture(scope="module", params=["smoke", "tiny"])
def cured(request, tiny_cfg, tiny_params):
    """Both packages through the whole slice on the same inputs."""
    if request.param == "smoke":
        jcfg = jax_get_smoke("llama3.1-8b")
        jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
        n_layers = 1
    else:
        jcfg, jparams = tiny_cfg, tiny_params
        n_layers = 2
    tcfg, tparams = port_cfg(jcfg), port_params(jparams)
    jcal, tcal = _batches(jcfg, 2, 2, 32, 1)
    jevl, tevl = _batches(jcfg, 2, 2, 32, 2)
    kw = dict(r_max=16, n_compress_layers=n_layers, svd="exact",
              fold_u=True)
    jcalib = jax_calibrate(jparams, jcfg, jcal)
    tcalib = calibrate(tparams, tcfg, tcal)
    jout = jax_compress_model(jparams, jcfg, JaxCURConfig(**kw), jcalib)
    tout = compress_model(tparams, tcfg, CURConfig(**kw), tcalib)
    return SimpleNamespace(jcfg=jcfg, jparams=jparams, tcfg=tcfg,
                           tparams=tparams, jcalib=jcalib, tcalib=tcalib,
                           jout=jout, tout=tout, jevl=jevl, tevl=tevl,
                           tcal=tcal, kw=kw)


def test_calibration_matches_jax(cured):
    assert cured.tcalib.n_tokens == cured.jcalib.n_tokens
    assert_close(cured.tcalib.hidden, np.asarray(cured.jcalib.hidden,
                                                 np.float32))
    for ta, ja in zip(cured.tcalib.act_sq, cured.jcalib.act_sq):
        assert sorted(ta) == sorted(ja)
        for t in ta:
            assert_close(ta[t], ja[t])


def test_same_layers_and_indices(cured):
    _, _, jinfo = cured.jout
    _, _, tinfo = cured.tout
    assert tinfo.layers == jinfo.layers
    assert len(tinfo.weights) == len(jinfo.weights) > 0
    for tw, jw in zip(tinfo.weights, jinfo.weights):
        assert (tw.layer, tw.name, tw.shape, tw.rank) == \
            (jw.layer, jw.name, tuple(jw.shape), jw.rank)
        np.testing.assert_array_equal(tw.rows, np.asarray(jw.rows))
        np.testing.assert_array_equal(tw.cols, np.asarray(jw.cols))
        assert tw.params_after == jw.params_after
    assert tinfo.params_saved == jinfo.params_saved


def test_folded_factors_match_jax(cured):
    jparams, _, jinfo = cured.jout
    tparams, _, _ = cured.tout
    for w in jinfo.weights:
        jl = _leaf(jparams, w.layer, w.name)
        tl = _leaf(tparams, w.layer, w.name)
        assert sorted(tl) == ["CU", "R"]
        assert_close(tl["CU"].numpy(), jl["CU"])
        assert_close(tl["R"].numpy(), jl["R"])


def test_weight_errors_match_jax(cured):
    for tw, jw in zip(cured.tout[2].weights, cured.jout[2].weights):
        assert abs(tw.fro_err - jw.fro_err) / jw.fro_err < 2e-5
        assert abs(tw.fro_w - jw.fro_w) / jw.fro_w < 2e-5
        assert abs(tw.bound - jw.bound) / jw.bound < 2e-5


def test_folded_logits_and_perplexity_match_jax(cured):
    jparams, jcfg2, _ = cured.jout
    tparams, tcfg2, _ = cured.tout
    assert tcfg2 == port_cfg(jcfg2)
    assert_close(forward(tparams, tcfg2, cured.tevl[0]).numpy(),
                 jax_forward(jparams, jcfg2, cured.jevl[0]))
    pj = jax_perplexity(jparams, jcfg2, cured.jevl)
    pt = perplexity(tparams, tcfg2, cured.tevl)
    assert math.isfinite(pt) and abs(pt - pj) / pj < 2e-5
    p0 = perplexity(cured.tparams, cured.tcfg, cured.tevl)
    assert abs(p0 - jax_perplexity(cured.jparams, cured.jcfg,
                                   cured.jevl)) / p0 < 2e-5


def test_folded_token_accuracy_matches_jax(cured):
    jparams, jcfg2, _ = cured.jout
    tparams, tcfg2, _ = cured.tout
    assert token_accuracy(tparams, tcfg2, cured.tevl) == \
        jax_token_accuracy(jparams, jcfg2, cured.jevl)


@pytest.mark.parametrize("svd", ["exact", "randomized"])
def test_loop_and_batched_select_identically(cured, svd):
    kw = dict(cured.kw, svd=svd)
    outs = [compress_model(cured.tparams, cured.tcfg,
                           CURConfig(pipeline=p, **kw), cured.tcalib)
            for p in ("loop", "batched")]
    (pl, _, il), (pb, _, ib) = outs
    assert il.layers == ib.layers
    for a, b in zip(il.weights, ib.weights):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
        assert_close(_leaf(pl, a.layer, a.name)["CU"].numpy(),
                     _leaf(pb, b.layer, b.name)["CU"].numpy())


def test_unfolded_leaves_keep_healing_form(cured):
    kw = dict(cured.kw, fold_u=False)
    tparams, _, tinfo = compress_model(cured.tparams, cured.tcfg,
                                       CURConfig(**kw), cured.tcalib)
    w = tinfo.weights[0]
    leaf = _leaf(tparams, w.layer, w.name)
    assert sorted(leaf) == ["C", "R", "U0", "dU"]
    assert leaf["U0"].dtype == torch.float32
    assert not leaf["dU"].any()
    assert w.params_after == w.params_after_unfolded


def test_compress_leaves_original_params_untouched(cured):
    jcfg = cured.jcfg
    before = cured.tparams["groups"][0][0]["wq"]
    assert torch.is_tensor(before)
    assert tuple(before.shape) == (jcfg.n_layers, jcfg.d_model,
                                   jcfg.n_heads * jcfg.resolved_head_dim)


_CURE_ARGV = ["--arch", "llama3.1-8b", "--smoke", "--layers", "1",
              "--r-max", "8", "--calib-batches", "1", "--calib-len", "16"]


def _cure_args(ckpt_dir, **over):
    args = tcure.parser().parse_args(
        _CURE_ARGV + ["--device", "cpu", "--ckpt-dir", str(ckpt_dir)])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def test_cure_launcher_report_schema(tmp_path):
    report = tcure.cure(_cure_args(tmp_path))
    assert report["device"] == "cpu"
    assert report["layers_compressed"] == [1]
    assert list(report["stages_s"]) == ["init", "calibrate", "plan",
                                        "compress", "fold", "save",
                                        "generate", "total"]
    assert report["params"]["saved_deployed"] > 0
    assert report["n_weights"] == len(report["weights"]) == 3
    assert {"layer", "name", "shape", "rank", "rel_fro_err", "bound",
            "bound_on", "seconds"} <= set(report["weights"][0])
    assert report["generate"]["tokens"] == 4 * 8


def test_cure_launcher_ckpt_dir_saves_a_restorable_checkpoint(tmp_path):
    """--ckpt-dir: step 0 of {"params": the CURed tree} with keep-N 1 and
    its template.json; it restores bit-identical through the template, and
    the report has the JAX launcher's keys on the same arguments (the
    port adds ``n_layers`` and ``device``; the JAX CLI takes olmo-1b, not
    llama3.1-8b)."""
    from repro.launch import cure as jax_cure
    from repro_torch.dist import CheckpointManager, load_tree_template
    argv = ["--arch", "olmo-1b"] + _CURE_ARGV[2:]
    run = tcure.cure_run(tcure.parser().parse_args(
        argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")]))
    mgr = CheckpointManager(str(tmp_path / "port"))
    assert mgr.all_steps() == [0] and mgr.latest_valid_step() == 0
    tmpl = load_tree_template(str(tmp_path / "port" / "template.json"))
    step, tree = mgr.restore(tmpl, device="cpu")
    mine = tree_flatten(tree["params"])
    ref = tree_flatten(run.cured_params)
    assert step == 0 and len(mine) == len(ref) > 0
    assert all(torch.equal(a, b) for a, b in zip(mine, ref))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jrep = jax_cure.main(argv + ["--ckpt-dir", str(tmp_path / "jax")])
    rep = run.report
    assert set(rep) - {"n_layers", "device"} == set(jrep)
    assert list(rep["stages_s"]) == list(jrep["stages_s"])
    assert set(rep["generate"]) == set(jrep["generate"])
    assert rep["generate"]["tokens"] == jrep["generate"]["tokens"]


def test_cure_launcher_new_tokens_generates_through_serving(tmp_path):
    report = tcure.cure(_cure_args(tmp_path, new_tokens=4))
    assert report["generate"]["tokens"] == 16
    assert report["generate"]["engine"] == "serving"
    assert report["generate"]["tok_per_s"] > 0
