"""Port parity for healing (paper §4.5): the trainable-leaf masks and the
(trainable, frozen) split for every mode, the KD loss and its gradients,
and eight dU-only heal steps, against the JAX package's on the same
bridged trees and numpy batches (2e-5, scale-relative); and what the
port's step promises: frozen leaves untouched and never holding a
gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import CURConfig as JaxCURConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core import calibrate as jax_calibrate
from repro.core import compress_model as jax_compress_model
from repro.core import heal as jheal
from repro.core.peft import wrap_model as jax_wrap_model
from repro.models import init_params as jax_init_params
from repro.models.model import forward_hidden as jax_forward_hidden
from repro.optim.adamw import AdamW as JaxAdamW
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import heal as theal
from repro_torch.dist import tree_flatten
from repro_torch.models import forward_hidden
from repro_torch.optim.adamw import AdamW

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)


def _batch(vocab, seed, B=2, S=24):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def heal_case():
    """SMOKE llama: dense teacher and its healing-form student (2 layers
    CURed at r 8), made by the JAX package and bridged."""
    jcfg = jax_get_smoke("llama3.1-8b")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    calib = jax_calibrate(jp, jcfg, [_jb(_batch(jcfg.vocab_size, 0))])
    sp, scfg, _ = jax_compress_model(
        jp, jcfg, JaxCURConfig(r_max=8, n_compress_layers=2), calib)
    return dict(jcfg=jcfg, jp=jp, sp=sp, scfg=scfg, cfg=port_cfg(jcfg),
                tp=port_params(jp), tsp=port_params(sp),
                tscfg=port_cfg(scfg))


def _trees(case, mode):
    """(JAX tree, port tree, JAX cfg, port cfg) for a mode."""
    if mode == "dU":
        return case["sp"], case["tsp"], case["scfg"], case["tscfg"]
    if mode == "all":
        return case["jp"], case["tp"], case["jcfg"], case["cfg"]
    wrapped = jax_wrap_model(case["jp"], case["jcfg"], mode, 8)
    return wrapped, port_params(wrapped), case["jcfg"], case["cfg"]


@pytest.mark.parametrize("mode", ["dU", "lora", "mora", "curlora", "all"])
def test_mask_partition_combine_match_jax(heal_case, mode):
    jtree, ttree, _, _ = _trees(heal_case, mode)
    jmask, tmask = jheal.trainable_mask(jtree, mode), \
        theal.trainable_mask(ttree, mode)
    assert tmask == jmask
    assert any(jax.tree.leaves(jmask))
    jtr, jfr = jheal.partition_params(jtree, jmask)
    ttr, tfr = theal.partition_params(ttree, tmask)
    none = jax.tree.map(lambda x: x is None, jtr, is_leaf=lambda x: x is None)
    assert jax.tree.map(lambda x: x is None, ttr,
                        is_leaf=lambda x: x is None) == none
    assert jax.tree.map(lambda x: x is None, tfr,
                        is_leaf=lambda x: x is None) == jax.tree.map(
        lambda x: x is None, jfr, is_leaf=lambda x: x is None)
    back = theal.combine_params(ttr, tfr)
    a, b = tree_flatten(back), tree_flatten(ttree)
    assert len(a) == len(b) and all(x is y for x, y in zip(a, b))


@pytest.mark.parametrize("flags", [(True, True), (True, False),
                                   (False, True)])
@pytest.mark.parametrize("mode", ["dU", "all"])
def test_kd_loss_and_gradients_match_jax(heal_case, mode, flags):
    """kd_loss_fn and its gradients over the trainable leaves: the dU of a
    healing-form student, or every leaf of a dense SMOKE student."""
    layer_mse, logit_kl = flags
    c = heal_case
    jtree, ttree, jcfg_s, tcfg_s = _trees(c, mode)
    b = _batch(c["jcfg"].vocab_size, 5)
    # the dense student distils from a teacher other than itself
    jt = c["jp"] if mode == "dU" else jax_init_params(
        jax.random.PRNGKey(1), c["jcfg"])
    tt = c["tp"] if mode == "dU" else port_params(jt)
    t_log, t_hid = jax.jit(lambda p, bb: jax_forward_hidden(
        p, c["jcfg"], bb))(jt, _jb(b))
    with torch.no_grad():
        tt_log, tt_hid = forward_hidden(tt, c["cfg"], _tb(b))
    assert_close(tt_hid.numpy(), np.asarray(t_hid))
    kw = dict(alpha=0.1, temp=10.0, layer_mse=layer_mse, logit_kl=logit_kl)
    jtr, jfr = jheal.partition_params(jtree, jheal.trainable_mask(jtree,
                                                                  mode))
    ttr, tfr = theal.partition_params(ttree, theal.trainable_mask(ttree,
                                                                  mode))
    jl, jg = jax.jit(jax.value_and_grad(lambda t, f, bb: jheal.kd_loss_fn(
        jheal.combine_params(t, f), jcfg_s, bb, t_log, t_hid,
        **kw)))(jtr, jfr, _jb(b))
    tl, tg = theal.value_and_grad(lambda t: theal.kd_loss_fn(
        theal.combine_params(t, tfr), tcfg_s, _tb(b), tt_log, tt_hid,
        **kw), ttr)
    assert_close(tl.numpy(), np.asarray(jl))
    jleaves = jax.tree.leaves(jax.device_get(jg))
    tleaves = tree_flatten(tg)
    assert len(jleaves) == len(tleaves) > 0
    for a, b_ in zip(tleaves, jleaves):
        assert a.shape == b_.shape
        assert_close(a.numpy(), b_)


def test_heal_steps_match_jax(heal_case):
    """Eight dU-only heal steps (AdamW, constant LR): per-step KD losses
    within 2e-5 of JAX's."""
    c = heal_case
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=50, schedule="constant")
    jopt, topt = JaxAdamW(JaxOptimizerConfig(**kw)), AdamW(
        OptimizerConfig(**kw))
    jtr, jfr = jheal.partition_params(
        c["sp"], jheal.trainable_mask(c["sp"], "dU"))
    ttr, tfr = theal.partition_params(
        c["tsp"], theal.trainable_mask(c["tsp"], "dU"))
    jstep = jax.jit(jheal.make_heal_step(c["scfg"], c["jcfg"], c["jp"],
                                         jopt))
    tstep = theal.make_heal_step(c["tscfg"], c["cfg"], c["tp"], topt)
    js, ts = jopt.init(jtr), topt.init(ttr)
    for s in range(8):
        b = _batch(c["jcfg"].vocab_size, 100 + s)
        jtr, js, jl = jstep(jtr, jfr, js, _jb(b))
        ttr, ts, tl = tstep(ttr, tfr, ts, _tb(b))
        assert_close(np.float32(float(tl)), np.float32(float(jl)))
    assert int(ts["step"]) == 8


def test_heal_step_freezes_frozen_and_moves_du(heal_case):
    c = heal_case
    tree = c["tsp"]
    before = [t.clone() for t in tree_flatten(tree)]
    ttr, tfr = theal.partition_params(tree, theal.trainable_mask(tree,
                                                                 "dU"))
    opt = AdamW(OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                                schedule="constant"))
    step = theal.make_heal_step(c["tscfg"], c["cfg"], c["tp"], opt)
    new_tr, _, loss = step(ttr, tfr, opt.init(ttr),
                           _tb(_batch(c["jcfg"].vocab_size, 7)))
    assert torch.isfinite(loss) and loss.grad_fn is None
    healed = theal.combine_params(new_tr, tfr)
    mask = tree_flatten(theal.trainable_mask(tree, "dU"))
    n_du = 0
    for old, cur, m in zip(before, tree_flatten(healed), mask):
        if m:
            n_du += 1
            assert not torch.equal(old, cur)
        else:
            assert torch.equal(old, cur)
    assert n_du == sum(1 for lp in c["tsp"]["groups"] for w in lp[0].values()
                       if isinstance(w, dict) and "dU" in w) > 0
    assert all(t.grad is None and not t.requires_grad
               for t in tree_flatten(tree) + tree_flatten(c["tp"]))
