"""Activation rematerialization in the port (``cfg.remat``,
``cfg.remat_policy``; ``repro_torch.models.model.apply_groups``).

Under JAX's conditions (``_maybe_remat``: ``cfg.remat`` and a group
scanned over more than one repeat, or any group under ``static_loops``)
each repeat's body runs under ``torch.utils.checkpoint``: the whole body
for ``"full"``, the mixer and the channel mixer apart for
``"save_mixer_outputs"``. The cases (f32, seeded):

  - the forward, the loss and every gradient of each policy equal the
    unwrapped model's (remat off) within 2e-5: llama's REPRO config,
    olmo, jamba (one period: under ``static_loops``) and mixtral SMOKEs,
    and olmo's as two groups (one rematerialized, one not);
  - the backward recomputes each body's sequence mixer exactly when JAX's
    conditions hold (once a layer), and not otherwise;
  - autograd keeps fewer bytes for the backward outside the checkpointed
    bodies than without remat;
  - olmo's gradients under each policy match JAX's (its ``jax.checkpoint``
    bodies) within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro_torch import bridge
from repro_torch.configs import ATTN, MLP, BlockSpec, get_repro, get_smoke
from repro_torch.core.heal import value_and_grad
from repro_torch.dist import tree_flatten
from repro_torch.models import init_params
from repro_torch.models import model as tmodel

from _torch_helpers import assert_close, port_cfg

torch.set_num_threads(1)

# name: (config, overrides that meet JAX's remat conditions)
CASES = {
    "llama-repro": (get_repro(), dict(scan_layers=True)),
    "olmo": (get_smoke("olmo-1b"), dict(scan_layers=True)),
    "jamba-static": (get_smoke("jamba-v0.1-52b"), dict(static_loops=True)),
    "mixtral": (get_smoke("mixtral-8x22b"), dict(scan_layers=True)),
    # two groups: the first (2 repeats) rematerialized, the second not;
    # the first's bodies run again after the second's forward
    "olmo-two-groups": (get_smoke("olmo-1b"), dict(
        scan_layers=True, groups=(((BlockSpec(ATTN, MLP),), 2),
                                  ((BlockSpec(ATTN, MLP),), 1)))),
}
POLICIES = ("full", "save_mixer_outputs")
B, S = 2, 16


def _case(name):
    base, over = CASES[name]
    cfg = base.replace(dtype="float32", **over)
    params = init_params(0, cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 1)))
    return cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _run(cfg, params, batch):
    logits = tmodel.forward(params, cfg, batch)
    loss, grads = value_and_grad(
        lambda p: tmodel.loss_fn(p, cfg, batch), params)
    return logits.detach(), loss, tree_flatten(grads)


@pytest.fixture(scope="module")
def unwrapped():
    out = {}
    for name in CASES:
        cfg, params, batch = _case(name)
        out[name] = _run(cfg.replace(remat=False), params, batch)
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(CASES))
def test_remat_matches_unwrapped(unwrapped, name, policy):
    cfg, params, batch = _case(name)
    logits, loss, grads = _run(
        cfg.replace(remat=True, remat_policy=policy), params, batch)
    want_logits, want_loss, want_grads = unwrapped[name]
    assert_close(logits.numpy(), want_logits.numpy())
    assert abs(float(loss) - float(want_loss)) <= 2e-5 * abs(
        float(want_loss))
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        assert_close(g.numpy(), w.numpy())


def _mixer_calls(monkeypatch, cfg, params, batch):
    calls = []
    real = tmodel._seq_mix

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tmodel, "_seq_mix", counted)
    value_and_grad(lambda p: tmodel.loss_fn(p, cfg, batch), params)
    return len(calls)


@pytest.mark.parametrize("policy", (None,) + POLICIES)
@pytest.mark.parametrize("name", ["olmo", "jamba-static", "olmo-two-groups",
                                  "olmo-unscanned"])
def test_backward_recomputes_under_jax_conditions(monkeypatch, name,
                                                  policy):
    """One sequence-mixer call a layer in the forward, and one more in
    the backward for each layer of a group where remat is on and JAX's
    conditions hold (a scanned group of 3 or 2 repeats, static_loops);
    a group of one repeat, and olmo unscanned (its SMOKE as it is), never
    recompute."""
    cfg, params, batch = _case("olmo" if name == "olmo-unscanned" else name)
    if name == "olmo-unscanned":
        cfg = cfg.replace(scan_layers=False)
    cfg = cfg.replace(remat=policy is not None,
                      remat_policy=policy or "full")
    n = _mixer_calls(monkeypatch, cfg, params, batch)
    again = {"olmo": 3, "jamba-static": 8, "olmo-two-groups": 2,
             "olmo-unscanned": 0}[name] if policy is not None else 0
    assert n == cfg.n_layers + again


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_keeps_fewer_bytes(policy):
    """The bytes autograd saves for the backward outside the checkpointed
    bodies (what a ``saved_tensors_hooks`` sees) drop under remat."""
    cfg, params, batch = _case("llama-repro")

    def saved(c):
        total = []

        def pack(t):
            total.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tmodel.loss_fn(_with_grad(params), c, batch)
        return sum(total)

    off = saved(cfg.replace(remat=False))
    on = saved(cfg.replace(remat=True, remat_policy=policy))
    assert on < off / 4, (on, off)


def _with_grad(params):
    return bridge.tree_map(lambda t: t.detach().requires_grad_(True), params)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_grads_match_jax(policy):
    jcfg = jax_get_smoke("olmo-1b").replace(
        scan_layers=True, remat=True, remat_policy=policy)
    cfg = port_cfg(jcfg)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jb)))(jp)
    params = bridge.to_torch(jax.device_get(jp), "cpu")
    batch = {k: torch.from_numpy(np.array(v)).long() for k, v in
             jb.items()}
    loss, grads = value_and_grad(
        lambda p: tmodel.loss_fn(p, cfg, batch), params)
    assert abs(float(loss) - float(jl)) <= 2e-5 * abs(float(jl))
    want = jax.tree.leaves(jax.device_get(jg))
    got = tree_flatten(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w))
