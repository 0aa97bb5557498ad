"""Port parity for the MoE channel mixer (``repro.models.moe`` on one
device): routing (gates within 2e-5, expert ids exact, ties broken toward
the lower index as ``jax.lax.top_k`` does) and ``moe_dense`` with and
without the shared expert, on the same numpy inputs (f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

from _torch_helpers import assert_close, port_cfg

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (16, 2), (16, 4)])
def test_route_matches_jax(E, k):
    rng = _rng(E + k)
    xt = rng.standard_normal((40, 32)).astype(np.float32)
    router = (rng.standard_normal((32, E)) / np.sqrt(32)).astype(np.float32)
    jg, je = jmoe.route(jnp.asarray(xt), jnp.asarray(router), k)
    tg, te = tmoe.route(torch.from_numpy(xt), torch.from_numpy(router), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert_close(tg.numpy(), np.asarray(jg))
    assert tg.dtype == torch.float32


@pytest.mark.parametrize("dup", [(0, 1), (2, 5), (6, 7)])
def test_route_ties_pick_the_lower_index(dup):
    """A router with two equal columns gives every token two equal
    probabilities: the top k must take the lower index first."""
    rng = _rng(7)
    E, k = 8, 2
    xt = rng.standard_normal((64, 16)).astype(np.float32)
    router = rng.standard_normal((16, E)).astype(np.float32)
    router[:, dup[1]] = router[:, dup[0]]
    # make the duplicated pair the largest logits of half the tokens
    router[:, dup[0]] *= 3.0
    router[:, dup[1]] = router[:, dup[0]]
    jg, je = jmoe.route(jnp.asarray(xt), jnp.asarray(router), k)
    tg, te = tmoe.route(torch.from_numpy(xt), torch.from_numpy(router), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert_close(tg.numpy(), np.asarray(jg))
    first = te.numpy()[:, 0]
    assert (first == dup[0]).any() and not (first == dup[1]).any()


def test_route_bf16_ties_match_jax():
    """bf16 logits tie often at E 8-16; the chosen experts still match."""
    rng = _rng(11)
    xt = rng.standard_normal((256, 8)).astype(np.float32)
    router = rng.standard_normal((8, 16)).astype(np.float32)
    jg, je = jmoe.route(jnp.asarray(xt, jnp.bfloat16), jnp.asarray(router), 2)
    tg, te = tmoe.route(torch.from_numpy(xt).bfloat16(),
                        torch.from_numpy(router), 2)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert_close(tg.numpy(), np.asarray(jg))


def _moe_params(cfg, rng):
    D, E = cfg.d_model, cfg.n_experts
    F = cfg.moe_d_ff or cfg.d_ff

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    p = {"router": w(D, E), "w_gate": w(E, D, F), "w_up": w(E, D, F),
         "w_down": w(E, F, D)}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * F
        p["shared"] = {"w_gate": w(D, Fs), "w_up": w(D, Fs),
                       "w_down": w(Fs, D)}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "jamba-v0.1-52b",
                                  "kimi-k2-1t-a32b"])
def test_moe_dense_matches_jax(arch):
    """mixtral and jamba: routed experts only; kimi: + the shared expert."""
    jcfg = jax_get_smoke(arch)
    cfg = port_cfg(jcfg)
    rng = _rng(3)
    p = _moe_params(cfg, rng)
    assert ("shared" in p) == bool(cfg.n_shared_experts)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    yj = jmoe.moe_forward(jnp.asarray(x), _tree(p, jnp.asarray), jcfg)
    yt = tmoe.moe_forward(torch.from_numpy(x), _tree(p, torch.from_numpy),
                          cfg)
    assert yt.shape == x.shape
    assert_close(yt.numpy(), np.asarray(yj))
    assert_close(tmoe.moe_dense(torch.from_numpy(x),
                                _tree(p, torch.from_numpy), cfg).numpy(),
                 np.asarray(jmoe.moe_dense(jnp.asarray(x),
                                           _tree(p, jnp.asarray), jcfg)))


def test_moe_dense_token_chunks_give_the_same_result(monkeypatch):
    """Long inputs run the experts over chunks of tokens; every token's
    output is the unchunked pass's (up to the products' summation order,
    which a GEMM may pick by its row count)."""
    cfg = port_cfg(jax_get_smoke("kimi-k2-1t-a32b"))
    rng = _rng(9)
    p = _tree(_moe_params(cfg, rng), torch.from_numpy)
    x = torch.from_numpy(rng.standard_normal((3, 17, cfg.d_model)).astype(
        np.float32))
    whole = tmoe.moe_dense(x, p, cfg)
    E, _, F = p["w_gate"].shape
    monkeypatch.setattr(tmoe, "CHUNK_ELEMS", E * F * 5)   # 5 tokens a chunk
    chunked = tmoe.moe_dense(x, p, cfg)
    assert_close(chunked.numpy(), whole.numpy())
