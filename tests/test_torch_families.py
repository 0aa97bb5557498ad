"""Port parity for every configuration of the JAX package: the configs and
their derived counts, forward / forward_hidden / loss on every SMOKE
config, gradients on the MoE, Mamba-2 and hybrid SMOKEs, and one AdamW
train step, all on the same bridged params and numpy inputs (f32,
scale-relative 2e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.configs.base import shape_applicable as jax_shape_applicable
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.model import forward_hidden as jax_forward_hidden
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train import train_loop as jloop
from repro_torch import bridge
from repro_torch.configs import (
    ARCHS, SHAPES, get_config, get_smoke, shape_applicable)
from repro_torch.configs.base import (
    ATTN, ATTN_LOCAL, MAMBA, MLP, MOE, OptimizerConfig)
from repro_torch.core.heal import value_and_grad
from repro_torch.dist import tree_flatten
from repro_torch.models import forward, forward_hidden, init_params, loss_fn
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_loop as tloop

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)

FAMILIES = ("jamba-v0.1-52b", "mixtral-8x22b", "kimi-k2-1t-a32b",
            "mamba2-1.3b")
B, S = 2, 24


@pytest.fixture(scope="module")
def smoke_models():
    """arch -> (jcfg, jparams, cfg, params), made once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_get_smoke(arch)
            jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
            cache[arch] = (jcfg, jparams, port_cfg(jcfg),
                           port_params(jparams))
        return cache[arch]
    return get


def _batch(cfg, seed=0):
    """(jax batch, port batch): tokens or embeddings, and labels."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.input_mode == "tokens":
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_registry_holds_every_jax_config():
    assert set(ARCHS) == set(JAX_ARCHS) | {"llama3.1-8b"}
    assert len(ARCHS) == 11
    assert set(SHAPES) == set(JAX_SHAPES)
    for a in ARCHS:
        for s in SHAPES:
            assert shape_applicable(a, SHAPES[s]) == \
                jax_shape_applicable(a, JAX_SHAPES[s])


@pytest.mark.parametrize("arch", sorted(set(JAX_ARCHS) | {"llama3.1-8b"}))
def test_configs_equal_jax(arch):
    jfull, jsmoke = jax_get_config(arch), jax_get_smoke(arch)
    full, smoke = get_config(arch), get_smoke(arch)
    assert port_cfg(jfull) == full
    assert port_cfg(jsmoke) == smoke
    for mine, theirs in ((full, jfull), (smoke, jsmoke)):
        assert mine.blocks == port_cfg(theirs).blocks
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert (mine.d_inner, mine.ssm_heads, mine.resolved_head_dim,
                mine.capacity_factor) == (
            theirs.d_inner, theirs.ssm_heads, theirs.resolved_head_dim,
            theirs.capacity_factor)


def _uncounted(cfg):
    """Leaves that the analytic ``param_count`` leaves out or adds, as the
    JAX package's formula does: qk-norm scales, the mamba conv biases,
    dt_bias and norm_z; norm2 counted on blocks with no channel mixer and
    the final norm on non-parametric norms; the embedding table of an
    embeddings-mode model."""
    d, n = cfg.d_model, 0
    for spec in cfg.blocks:
        if spec.mixer in (ATTN, ATTN_LOCAL) and cfg.qk_norm:
            n += 2 * cfg.resolved_head_dim
        if spec.mixer == MAMBA:
            n += cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads + cfg.d_inner
        if cfg.parametric_norm and spec.mlp not in (MLP, MOE):
            n -= d
    if not cfg.parametric_norm:
        n -= d
    if cfg.input_mode != "tokens":
        n -= cfg.vocab_size * d
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_leaf_count(arch, smoke_models):
    jcfg, jparams, cfg, _ = smoke_models(arch)
    own = init_params(0, cfg, device="cpu")
    leaves = bridge.flatten_up_to(own, own)
    n = sum(t.numel() for t in leaves)
    assert n == sum(a.size for a in jax.tree.leaves(jparams))
    assert n == cfg.param_count() + _uncounted(cfg)
    # the same tree and leaf dtypes as the JAX package's init
    jleaves = jax.tree.leaves(jax.device_get(jparams))
    assert [tuple(t.shape) for t in leaves] == [a.shape for a in jleaves]
    assert [str(t.dtype).split(".")[-1] for t in leaves] == \
        [str(a.dtype) for a in jleaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, smoke_models):
    jcfg, jparams, cfg, params = smoke_models(arch)
    jb, tb = _batch(cfg)
    y = forward(params, cfg, tb)
    assert y.shape == (B, S, cfg.vocab_size)
    assert_close(y.numpy(), np.asarray(jax_forward(jparams, jcfg, jb)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_jax(arch, smoke_models):
    jcfg, jparams, cfg, params = smoke_models(arch)
    jb, tb = _batch(cfg, seed=1)
    y, h = forward_hidden(params, cfg, tb)
    jy, jh = jax_forward_hidden(jparams, jcfg, jb)
    assert h.shape == (cfg.n_layers + 1, B, S, cfg.d_model)
    assert_close(y.numpy(), np.asarray(jy))
    assert_close(h.numpy(), np.asarray(jh))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch, smoke_models):
    jcfg, jparams, cfg, params = smoke_models(arch)
    jb, tb = _batch(cfg, seed=2)
    assert_close(loss_fn(params, cfg, tb).numpy(),
                 np.asarray(jax_loss_fn(jparams, jcfg, jb)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_gradients_match_jax(arch, smoke_models):
    jcfg, jparams, cfg, params = smoke_models(arch)
    jb, tb = _batch(cfg, seed=3)
    jl, jg = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jb))(jparams)
    tl, tg = value_and_grad(lambda p: loss_fn(p, cfg, tb), params)
    assert_close(tl.numpy(), np.asarray(jl))
    jleaves = jax.tree.leaves(jax.device_get(jg))
    tleaves = tree_flatten(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert a.shape == b.shape
        assert_close(a.numpy(), b)


OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)


@pytest.mark.parametrize("arch", FAMILIES + ("gemma3-1b", "pixtral-12b"))
def test_train_step_matches_jax(arch, smoke_models):
    """One AdamW step, held in its two halves on the same inputs: the
    step's loss (and the next step's, which the new params decide) within
    2e-5 of ``make_train_step``'s, and the port's update of the JAX
    gradients equal to the JAX update of them. The new params of the two
    whole steps are not compared leaf by leaf: Adam's first step is
    g / (|g| + eps), so a gradient entry near eps (1e-8, some 1e-6 of the
    largest) turns f32 rounding of the gradient into an O(lr) move."""
    jcfg, jparams, cfg, params = smoke_models(arch)
    jopt = JaxAdamW(JaxOptimizerConfig(**OPT))
    topt = AdamW(OptimizerConfig(**OPT))
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt))
    tstep = tloop.make_train_step(cfg, topt)
    jb, tb = _batch(cfg, seed=4)
    js, ts = jopt.init(jparams), topt.init(params)
    jp, js, jl = jstep(jparams, js, jb)
    tp, ts, tl = tstep(params, ts, tb)
    assert_close(np.float32(float(tl)), np.float32(float(jl)))
    jp, js, jl = jstep(jp, js, jb)
    tp, ts, tl = tstep(tp, ts, tb)
    assert_close(np.float32(float(tl)), np.float32(float(jl)))
    assert int(ts["step"]) == 2

    jg = jax.grad(lambda p: jax_loss_fn(p, jcfg, jb))(jparams)
    jnew, _ = jopt.update(jparams, jg, jopt.init(jparams))
    tnew, _ = topt.update(params, port_params(jg), topt.init(params))
    jleaves = jax.tree.leaves(jax.device_get(jnew))
    tleaves = tree_flatten(tnew)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert_close(a.numpy(), b)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "kimi-k2-1t-a32b"])
def test_bridge_round_trip_keeps_expert_stacks_and_f32_leaves(arch):
    """A bf16 JAX tree with 4-D expert stacks (reps, E, D, F) and f32
    leaves (router, A_log, D, dt_bias) crosses the bridge and back
    bit-identical, each leaf in its own dtype."""
    jcfg = jax_get_smoke(arch).replace(dtype="bfloat16")
    jparams = jax.device_get(jax_init_params(jax.random.PRNGKey(1), jcfg))
    tparams = port_params(jparams)
    jleaves = jax.tree.leaves(jparams)
    tleaves = tree_flatten(tparams)
    dtypes = {str(a.dtype) for a in jleaves}
    assert dtypes == {"bfloat16", "float32"}
    assert any(a.ndim == 4 for a in jleaves)
    for a, t in zip(jleaves, tleaves):
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
        assert tuple(t.shape) == a.shape
    back = jax.tree.leaves(bridge.to_numpy(tparams))
    for a, b in zip(jleaves, back):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "gemma3-1b",
                                  "kimi-k2-1t-a32b"])
def test_unrolled_multi_position_patterns_match_jax(arch, smoke_models):
    """Per-layer groups of a period-8 (jamba) or (L x 5, G) + (L, L)
    (gemma3) pattern: the same layers in the same order as JAX's
    ``unroll_params``, and the forward unchanged."""
    from repro.core.compress import unroll_params as jax_unroll_params
    from repro.core.compress import unrolled_config as jax_unrolled_config
    from repro_torch.core.compress import unroll_params, unrolled_config
    jcfg, jparams, cfg, params = smoke_models(arch)
    ucfg = unrolled_config(cfg)
    assert ucfg == port_cfg(jax_unrolled_config(jcfg))
    assert len(ucfg.groups) == cfg.n_layers
    up = unroll_params(params, cfg)
    jup = jax.tree.leaves(jax.device_get(jax_unroll_params(jparams, jcfg)))
    tup = tree_flatten(up)
    assert [tuple(t.shape) for t in tup] == [a.shape for a in jup]
    for a, b in zip(tup, jup):
        np.testing.assert_array_equal(a.numpy(), b)
    _, tb = _batch(cfg, seed=5)
    assert torch.equal(forward(up, ucfg, tb), forward(params, cfg, tb))


def test_layer_views_leave_no_reference_cycle():
    """Walking a model's layers (per-layer views of the stacked leaves)
    and unflattening trees creates no reference cycle: once the caller
    drops the params, their storage is freed at once, without waiting for
    the garbage collector (a cycle there held whole full-width models)."""
    import gc
    import weakref
    from repro_torch.models.model import iter_layer_params
    cfg = get_smoke("jamba-v0.1-52b")
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        params = init_params(0, cfg, device="cpu")
        refs = [weakref.ref(t) for t in tree_flatten(params)]
        views = [lp for _, _, lp in iter_layer_params(params, cfg)]
        again = bridge.unflatten_as(params, bridge.flatten_up_to(params,
                                                                 params))
        del params, views, again
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()
