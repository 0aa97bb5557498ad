"""Port parity for the PEFT baselines (LoRA, MoRA, CURLoRA). The port
draws from a torch.Generator, which cannot reproduce ``jax.random``, so
``wrap_model`` is held on budgets, shapes, dtypes and zero-inits; forward
passes and heal steps are compared on JAX-wrapped trees bridged into the
port (2e-5, scale-relative); CURLoRA's indices are checked for what they
must be: distinct, in range, and the columns / rows of W."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core import heal as jheal
from repro.core import peft as jpeft
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.layers import _mora_apply as jax_mora_apply
from repro.optim.adamw import AdamW as JaxAdamW
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import heal as theal
from repro_torch.core import peft as tpeft
from repro_torch.dist import tree_flatten
from repro_torch.models import forward
from repro_torch.models.layers import _mora_apply
from repro_torch.optim.adamw import AdamW

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)

MODES = ("lora", "mora", "curlora")


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_smoke("llama3.1-8b")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, port_cfg(jcfg), port_params(jp)


def _batch(vocab, seed=0, B=2, S=16):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_lora_rank_for_budget_matches_jax():
    for m, n, r in ((4096, 14336, 256), (10_000, 10_000, 4), (64, 32, 8),
                    (256, 704, 64)):
        assert tpeft.lora_rank_for_budget(m, n, r) == \
            jpeft.lora_rank_for_budget(m, n, r)


@pytest.mark.parametrize("r", [4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_wrap_model_matches_jax_budgets_shapes_and_inits(smoke, mode, r):
    jcfg, jp, cfg, tp = smoke
    jw = jpeft.wrap_model(jp, jcfg, mode, r, seed=0)
    tw = tpeft.wrap_model(tp, cfg, mode, r, seed=0)
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jw))
    tl = tree_flatten(tw)
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert b.shape == a.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        name = jax.tree_util.keystr(path)
        if any(z in name for z in ("lora_B", "mora", "cU")):
            assert not b.any() and not np.asarray(a).any()
    jmask = jheal.trainable_mask(jw, mode)
    assert tpeft.count_trainable(tw, theal.trainable_mask(tw, mode)) == \
        jpeft.count_trainable(jw, jmask) > 0
    # the input tree is left as it was
    assert all(isinstance(tp["groups"][0][0][t], torch.Tensor)
               for t in cfg.cur_targets)


def test_curlora_indices_distinct_in_range_and_of_w(smoke):
    jcfg, _, cfg, tp = smoke
    tw = tpeft.wrap_model(tp, cfg, "curlora", 8, seed=3)
    block, base = tw["groups"][0][0], tp["groups"][0][0]
    for t in cfg.cur_targets:
        for rep in range(base[t].shape[0]):
            W = base[t][rep]
            cC, cR = block[t]["cC"][rep], block[t]["cR"][rep]
            # recover q and p: each cC column is a column of W, each cR
            # row a row of W
            q = [int(torch.nonzero((W == cC[:, j:j + 1]).all(0))[0])
                 for j in range(cC.shape[1])]
            p = [int(torch.nonzero((W == cR[i:i + 1]).all(1))[0])
                 for i in range(cR.shape[0])]
            assert len(set(q)) == len(q) == min(8, W.shape[1])
            assert len(set(p)) == len(p) == min(8, W.shape[0])
            assert all(0 <= i < W.shape[1] for i in q)
            assert all(0 <= i < W.shape[0] for i in p)
            assert torch.equal(cC, W[:, q]) and torch.equal(cR, W[p, :])


def _perturbed(jw, mode, seed=0):
    """JAX-wrapped tree with its trainable adapter leaves made nonzero
    (numpy draws), so the adapters change the forward."""
    rng = np.random.default_rng(seed)
    mask = jheal.trainable_mask(jw, mode)
    return jax.tree.map(
        lambda a, m: jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                 a.dtype) if m else a, jw, mask)


@pytest.mark.parametrize("mode", MODES)
def test_adapter_forward_matches_jax(smoke, mode):
    jcfg, jp, cfg, tp = smoke
    jw = _perturbed(jpeft.wrap_model(jp, jcfg, mode, 8), mode)
    b = _batch(jcfg.vocab_size)
    want = jax_forward(jw, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    got = forward(port_params(jw), cfg,
                  {k: torch.from_numpy(v) for k, v in b.items()})
    assert_close(got.numpy(), np.asarray(want))
    base = forward(tp, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    assert not torch.allclose(got, base)


@pytest.mark.parametrize("mode", MODES)
def test_zero_init_adapters_are_identity(smoke, mode):
    _, _, cfg, tp = smoke
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
    assert_close(forward(tpeft.wrap_model(tp, cfg, mode, 8), cfg,
                         b).numpy(), forward(tp, cfg, b).numpy())


@pytest.mark.parametrize("mode", MODES)
def test_adapter_heal_steps_match_jax(smoke, mode):
    """Three KD heal steps training only the adapter leaves of a
    JAX-wrapped tree, the dense model as teacher: per-step losses within
    2e-5."""
    jcfg, jp, cfg, tp = smoke
    jw = _perturbed(jpeft.wrap_model(jp, jcfg, mode, 8), mode, seed=1)
    tw = port_params(jw)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, schedule="constant")
    jopt, topt = JaxAdamW(JaxOptimizerConfig(**kw)), AdamW(
        OptimizerConfig(**kw))
    jtr, jfr = jheal.partition_params(jw, jheal.trainable_mask(jw, mode))
    ttr, tfr = theal.partition_params(tw, theal.trainable_mask(tw, mode))
    jstep = jax.jit(jheal.make_heal_step(jcfg, jcfg, jp, jopt, mode=mode))
    tstep = theal.make_heal_step(cfg, cfg, tp, topt, mode=mode)
    js, ts = jopt.init(jtr), topt.init(ttr)
    for s in range(3):
        b = _batch(jcfg.vocab_size, seed=10 + s)
        jtr, js, jl = jstep(jtr, jfr, js,
                            {k: jnp.asarray(v) for k, v in b.items()})
        ttr, ts, tl = tstep(ttr, tfr, ts,
                            {k: torch.from_numpy(v) for k, v in b.items()})
        assert_close(np.float32(float(tl)), np.float32(float(jl)))


@pytest.mark.parametrize("m,r,n_out", [(20, 8, 12), (64, 8, 64),
                                       (30, 7, 50)])
def test_mora_apply_matches_jax(m, r, n_out):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, m)).astype(np.float32)
    M = rng.standard_normal((r, r)).astype(np.float32)
    got = _mora_apply(torch.from_numpy(x), torch.from_numpy(M), n_out)
    want = jax_mora_apply(jnp.asarray(x), jnp.asarray(M), n_out)
    assert got.shape == want.shape
    assert_close(got.numpy(), np.asarray(want))
