"""Parity of the dense-cache serving path: ``init_cache -> prefill ->
decode_step`` and the static-batch engine ``generate``, against the JAX
package's on the same bridged params and numpy tokens (f32), and against
the port's own ``forward()``. Logits are held to 2e-5 scale-relative;
cache positions, greedy tokens and early exits must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs import get_repro as jax_get_repro
from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import ATTN, ATTN_LOCAL, MLP, BlockSpec
from repro.configs.base import CURConfig as JaxCURConfig
from repro.core import calibrate as jax_calibrate
from repro.core import compress_model as jax_compress_model
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serve.engine import generate as jax_generate
from repro_torch import bridge
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.serve import engine

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)


def _local_cfg():
    """SMOKE llama with a sliding-window layer in every repeat (window 8):
    the ring-buffer path of the dense cache."""
    return jax_get_smoke("llama3.1-8b").replace(
        name="local-smoke", n_layers=4, window=8,
        groups=(((BlockSpec(ATTN_LOCAL, MLP), BlockSpec(ATTN, MLP)), 2),))


_CFGS = {"smoke": lambda: jax_get_smoke("llama3.1-8b"),
         "repro": jax_get_repro, "local": _local_cfg}


@pytest.fixture(scope="module", params=sorted(_CFGS))
def model(request):
    jcfg = _CFGS[request.param]()
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, jparams, port_cfg(jcfg), port_params(jparams)


def _tokens(V, B, S, seed):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


def _assert_caches_equal(jcache, tcache):
    """The port's cache tree equals the JAX one through the bridge: the
    same structure, K/V within 2e-5, positions exact."""
    jc = jax.device_get(jcache)
    tc = bridge.to_numpy(tcache)
    assert len(jc["groups"]) == len(tc["groups"])
    for jg, tg in zip(jc["groups"], tc["groups"]):
        assert len(jg) == len(tg)
        for jl, tl in zip(jg, tg):
            assert sorted(jl) == sorted(tl) == ["k", "pos", "v"]
            for key in ("k", "v"):
                assert jl[key].shape == tl[key].shape
                assert_close(tl[key], jl[key])
            np.testing.assert_array_equal(tl["pos"], jl["pos"])


def test_prefill_decode_match_jax_and_forward(model):
    """Prefill S - 4 tokens then decode 4: logits equal JAX's and the
    port's full forward at every position; caches equal JAX's."""
    name, jcfg, jparams, cfg, params = model
    B, S = 2, (40 if name == "local" else 24)
    toks = _tokens(cfg.vocab_size, B, S, seed=1)
    n_pre = S - 4
    full = forward(params, cfg, {"tokens": torch.from_numpy(toks).long()})
    jcache = jax_init_cache(jcfg, B, S)
    cache = init_cache(cfg, B, S, "cpu")
    jprefill = jax.jit(jax_prefill, static_argnums=1)
    jdecode = jax.jit(jax_decode_step, static_argnums=1)
    jl, jcache = jprefill(jparams, jcfg,
                          {"tokens": jnp.asarray(toks[:, :n_pre])}, jcache)
    tl, cache = prefill(params, cfg,
                        {"tokens": torch.from_numpy(toks[:, :n_pre]).long()},
                        cache)
    assert_close(tl.numpy(), np.asarray(jl))
    assert_close(tl.numpy(), full[:, n_pre - 1].numpy())
    for t in range(n_pre, S):
        jpos = jnp.full((B, 1), t, jnp.int32)
        pos = torch.full((B, 1), t, dtype=torch.int32)
        jl, jcache = jdecode(
            jparams, jcfg, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            jcache, jpos)
        tl, cache = decode_step(
            params, cfg, {"tokens": torch.from_numpy(toks[:, t:t + 1])
                          .long()}, cache, pos)
        assert_close(tl.numpy(), np.asarray(jl))
        assert_close(tl.numpy(), full[:, t].numpy())
    _assert_caches_equal(jcache, cache)


def test_ring_buffer_caches_are_window_sized():
    """Local layers keep min(max_len, window) slots; a prefill longer than
    the window keeps the trailing window at slot ``pos % window``, as in
    the JAX package (tests/test_decode.py::test_ring_buffer_long_decode)."""
    jcfg = _local_cfg()
    cfg = port_cfg(jcfg)
    cache = init_cache(cfg, 1, 40, "cpu")
    jcache = jax_init_cache(jcfg, 1, 40)
    shapes = [tuple(c["k"].shape) for c in cache["groups"][0]]
    assert shapes == [(2, 1, 8, 2, 16), (2, 1, 40, 2, 16)]
    assert shapes == [tuple(c["k"].shape) for c in jcache["groups"][0]]
    assert all(bool((c["pos"] == -1).all()) for c in cache["groups"][0])
    toks = _tokens(cfg.vocab_size, 1, 20, seed=2)
    params = port_params(jax_init_params(jax.random.PRNGKey(0), jcfg))
    _, cache = prefill(params, cfg, {"tokens": torch.from_numpy(toks)
                                     .long()}, cache)
    ring = cache["groups"][0][0]["pos"][0, 0]
    assert ring.tolist() == [16, 17, 18, 19, 12, 13, 14, 15]


def _jax_cured_smoke():
    jcfg = jax_get_smoke("llama3.1-8b")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    calib = jax_calibrate(jparams, jcfg, [{"tokens": jnp.asarray(
        _tokens(jcfg.vocab_size, 2, 32, seed=3))}])
    return jax_compress_model(
        jparams, jcfg, JaxCURConfig(r_max=8, n_compress_layers=2,
                                    svd="exact", fold_u=True), calib)[:2]


@pytest.fixture(scope="module", params=["original", "cured"])
def smoke(request):
    if request.param == "original":
        jcfg = jax_get_smoke("llama3.1-8b")
        jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    else:
        jparams, jcfg = _jax_cured_smoke()
    return jcfg, jparams, port_cfg(jcfg), port_params(jparams)


def test_generate_greedy_matches_jax(smoke):
    jcfg, jparams, cfg, params = smoke
    toks = _tokens(cfg.vocab_size, 3, 8, seed=7)
    ref = jax_generate(jparams, jcfg, jnp.asarray(toks), 6)
    out = engine.generate(params, cfg, torch.from_numpy(toks), 6)
    assert out.tokens.shape == (3, 6)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert_close(out.logprobs.numpy(), np.asarray(ref.logprobs))


def test_generate_eos_freeze_and_early_exit_match_jax(smoke):
    """tests/test_serving.py's eos case on both packages: finished rows
    emit eos with logprob 0, and the loop stops once every row is done."""
    jcfg, jparams, cfg, params = smoke
    p = np.repeat(_tokens(cfg.vocab_size, 1, 8, seed=5), 2, axis=0)
    free = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(p), 8).tokens)
    eos = int(free[0, 2])
    ref = jax_generate(jparams, jcfg, jnp.asarray(p), 8, eos_id=eos)
    out = engine.generate(params, cfg, torch.from_numpy(p), 8, eos_id=eos)
    toks, lps = out.tokens.numpy(), out.logprobs.numpy()
    np.testing.assert_array_equal(toks, np.asarray(ref.tokens))
    assert_close(lps, np.asarray(ref.logprobs))
    i = int(np.argmax(toks[0] == eos))
    assert (toks[:, i + 1:] == eos).all() and (lps[:, i + 1:] == 0.0).all()
    assert toks.shape[1] == i + 1 <= 3          # the early exit
    plain = engine.generate(params, cfg, torch.from_numpy(p), 8)
    np.testing.assert_array_equal(plain.tokens.numpy(), free)


def test_generate_temperature_deterministic_and_distributed():
    """Temperature sampling draws from one seeded generator: the same
    seed gives the same tokens, another seed others; the first token of
    many copies of one prompt follows softmax(prefill logits / T) (a
    chi-square test at p > 1e-3)."""
    jcfg = jax_get_smoke("llama3.1-8b")
    cfg = port_cfg(jcfg)
    params = port_params(jax_init_params(jax.random.PRNGKey(0), jcfg))
    p = torch.from_numpy(_tokens(cfg.vocab_size, 1, 8, seed=9))
    a = engine.generate(params, cfg, p.repeat(4, 1), 5, temperature=0.9,
                        seed=3)
    b = engine.generate(params, cfg, p.repeat(4, 1), 5, temperature=0.9,
                        seed=3)
    c = engine.generate(params, cfg, p.repeat(4, 1), 5, temperature=0.9,
                        seed=4)
    assert torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.tokens, c.tokens)
    T, n = 0.5, 4000
    out = engine.generate(params, cfg, p.repeat(n, 1), 1, temperature=T,
                          seed=0)
    logits, _ = prefill(params, cfg, {"tokens": p.long()},
                        init_cache(cfg, 1, 8, "cpu"))
    probs = torch.softmax(logits[0].double() / T, dim=-1).numpy()
    counts = np.bincount(out.tokens[:, 0].numpy(),
                         minlength=cfg.vocab_size)
    # pool the categories expected fewer than 5 times into one bin
    big = probs * n >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(probs[big], probs[~big].sum()) * n
    assert stats.chisquare(obs, exp).pvalue > 1e-3
