"""Port parity for training: the train step (with and without microbatch
accumulation, with error-feedback int8 gradients) against the JAX
package's on the same bridged params and numpy batches, per-step losses
and a step's gradients within 2e-5; the straggler watchdog's flags; a
resumed run's losses bitwise equal to the uninterrupted run's on the CPU;
the zoo; and checkpoints of either package's train CLI resuming in the
other's."""
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
from repro.launch import train as jax_train_cli
from repro.models import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train import train_loop as jloop
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.core.heal import value_and_grad
from repro_torch.dist import CheckpointManager, tree_flatten
from repro_torch.dist.compression import init_residuals
from repro_torch.launch import train as train_cli
from repro_torch.models import loss_fn
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_loop as tloop

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)

ARCHS = ("llama3.1-8b", "olmo-1b")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def _batches(vocab, n, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1))
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _setup(arch):
    jcfg = jax_get_smoke(arch)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, port_cfg(jcfg), port_params(jparams)


def _assert_losses(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_close(np.float32(a), np.float32(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch):
    jcfg, jparams, cfg, params = _setup(arch)
    b = _batches(jcfg.vocab_size, 1)[0]
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jax_loss_fn(p, jcfg, bb)))(jparams, _jb(b))
    tl, tg = value_and_grad(lambda p: loss_fn(p, cfg, _tb(b)), params)
    assert_close(tl.numpy(), np.asarray(jl))
    jleaves = jax.tree.leaves(jax.device_get(jg))
    tleaves = tree_flatten(tg)
    assert len(jleaves) == len(tleaves)
    for a, b_ in zip(tleaves, jleaves):
        assert a.shape == b_.shape
        assert_close(a.numpy(), b_)
    # the caller's params hold no gradient
    assert all(t.grad is None and not t.requires_grad
               for t in tree_flatten(params))


@pytest.mark.parametrize("micro", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, micro):
    jcfg, jparams, cfg, params = _setup(arch)
    jopt, topt = JaxAdamW(JaxOptimizerConfig(**OPT)), AdamW(
        OptimizerConfig(**OPT))
    jstep = jax.jit(jloop.make_train_step(
        jcfg, jopt, JaxTrainConfig(microbatch=micro)))
    tstep = tloop.make_train_step(cfg, topt, TrainConfig(microbatch=micro))
    js, ts = jopt.init(jparams), topt.init(params)
    jl, tl = [], []
    for b in _batches(jcfg.vocab_size, 8):
        jparams, js, l1 = jstep(jparams, js, _jb(b))
        params, ts, l2 = tstep(params, ts, _tb(b))
        jl.append(float(l1))
        tl.append(float(l2))
    _assert_losses(tl, jl)
    assert int(ts["step"]) == 8


def test_ef_train_steps_match_jax():
    jcfg, jparams, cfg, params = _setup("olmo-1b")
    jopt, topt = JaxAdamW(JaxOptimizerConfig(**OPT)), AdamW(
        OptimizerConfig(**OPT))
    tcfg = dict(grad_compress="ef_int8")
    jstep = jax.jit(jloop.make_ef_train_step(jcfg, jopt,
                                             JaxTrainConfig(**tcfg)))
    tstep = tloop.make_ef_train_step(cfg, topt, TrainConfig(**tcfg))
    js, ts = jopt.init(jparams), topt.init(params)
    jr, tr = jax_init_residuals(jparams), init_residuals(params)
    jl, tl = [], []
    for b in _batches(jcfg.vocab_size, 8, seed=1):
        jparams, js, jr, l1 = jstep(jparams, js, jr, _jb(b))
        params, ts, tr, l2 = tstep(params, ts, tr, _tb(b))
        jl.append(float(l1))
        tl.append(float(l2))
    _assert_losses(tl, jl)
    assert all(r.dtype == torch.float32 for r in tree_flatten(tr))


def test_straggler_watchdog_matches_jax():
    rng = np.random.default_rng(0)
    times = list(0.1 + 0.01 * rng.random(40))
    for i in (9, 15, 33):
        times[i] = 0.5
    times[20] = 0.29                       # just under 3x the median
    jw, tw = jloop.StragglerWatchdog(), tloop.StragglerWatchdog()
    jf = [jw.observe(i, t) for i, t in enumerate(times)]
    tf = [tw.observe(i, t) for i, t in enumerate(times)]
    assert tf == jf and tw.flagged == jw.flagged
    assert [s for s, *_ in tw.flagged] == [9, 15, 33]


def test_train_resume_losses_bitwise_on_cpu(tmp_path):
    """Train 6 steps with a checkpoint every 3; resume from step 3 into a
    fresh run: steps 3..5 give the uninterrupted run's losses, bitwise."""
    cfg = port_cfg(jax_get_smoke("llama3.1-8b"))
    from repro_torch.models import init_params
    params = init_params(0, cfg, "cpu")
    ocfg = OptimizerConfig(**dict(OPT, total_steps=6))
    batches = [_tb(b) for b in _batches(cfg.vocab_size, 6, seed=2)]
    mgr = CheckpointManager(str(tmp_path))
    _, _, full = tloop.train(params, cfg, ocfg, batches, ckpt_manager=mgr,
                             ckpt_every=3)
    assert mgr.all_steps() == [3, 6]
    template = {"params": params, "opt_state": AdamW(ocfg).init(params)}
    step, state = mgr.restore(template, device="cpu", step=3)
    _, ost, resumed = tloop.train(state["params"], cfg, ocfg, batches[3:],
                                  start_step=3,
                                  opt_state=state["opt_state"])
    assert step == 3 and int(ost["step"]) == 6
    assert resumed == full[3:]


def test_zoo_trains_caches_and_restores(tmp_path, capsys):
    from repro_torch import zoo
    params, cfg = zoo.get_trained_repro(3, device="cpu",
                                        zoo_dir=str(tmp_path))
    assert "step     0 loss" in capsys.readouterr().out
    again, _ = zoo.get_trained_repro(3, device="cpu", zoo_dir=str(tmp_path))
    assert capsys.readouterr().out == ""          # restored, not retrained
    a, b = tree_flatten(params), tree_flatten(again)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    ev = zoo.eval_batches(cfg, n=2, device="cpu")
    assert len(ev) == 2 and ev[0]["tokens"].shape == (zoo.BATCH, zoo.SEQ_LEN)
    assert zoo.data_config(cfg, seed=3).seed == 3


# ---------------------------------------------------------------------------
# cross-package resume through the two train CLIs
# ---------------------------------------------------------------------------

def _jax_cli(monkeypatch, capsys, *argv):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    jax_train_cli.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("compress", [False, True])
def test_train_cli_checkpoints_cross_packages(tmp_path, monkeypatch, capsys,
                                              compress):
    d = str(tmp_path)
    base = ["--arch", "olmo-1b", "--smoke", "--seq-len", "16", "--batch",
            "2", "--ckpt-dir", d, "--ckpt-every", "2"]
    ef = ["--grad-compress", "ef_int8"] if compress else []
    _jax_cli(monkeypatch, capsys, *base, "--steps", "2", *ef)
    # JAX -> port: the port resumes params, Adam moments + step, residuals
    run = train_cli.run(train_cli.parser().parse_args(
        base + ["--steps", "4", "--resume", "--device", "cpu"] + ef))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "note:" not in out
    assert run.start == 2 and int(run.opt_state["step"]) == 4
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    # port -> JAX, with --grad-compress toggled: JAX picks the template by
    # leaf count and prints its note
    out = _jax_cli(monkeypatch, capsys, *base, "--steps", "6", "--resume",
                   *([] if compress else ["--grad-compress", "ef_int8"]))
    assert "resumed from step 4" in out
    assert ("discarding them" in out) if compress else (
        "starting fresh" in out)
    # and back: JAX's step 6, written with the flag toggled
    run = train_cli.run(train_cli.parser().parse_args(
        base + ["--steps", "8", "--resume", "--device", "cpu"] + ef))
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and int(run.opt_state["step"]) == 8
    assert ("starting fresh" in out) if compress else (
        "discarding them" in out)
