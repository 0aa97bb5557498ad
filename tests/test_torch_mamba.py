"""Port parity for the Mamba-2 block (``repro.models.mamba``): the causal
conv, the chunked SSD scan (S a multiple of the chunk, ragged, shorter
than a chunk, with an initial state), the block forward, prefill's cache
(also when S < K - 1) and token-by-token decode, on the same numpy inputs
and bridged params (f32, scale-relative 2e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro.models import mamba as jmb
from repro_torch.models import mamba as tmb

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


def test_softplus_matches_jax():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [-1e3, 1e3, 0.0]]).astype(np.float32)
    assert_close(tmb.softplus(torch.from_numpy(x)).numpy(),
                 np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_causal_conv_matches_jax():
    rng = _rng(0)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    yt = tmb._causal_conv(*map(torch.from_numpy, (x, w, b)))
    yj = jmb._causal_conv(*map(jnp.asarray, (x, w, b)))
    assert_close(yt.numpy(), np.asarray(yj))


def _ssd_inputs(S, seed=1, B=2, nh=3, hp=4, N=5):
    rng = _rng(seed)
    xh = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (B, S, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (nh,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, nh, hp, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("S,chunk,init", [
    (32, 8, False),      # a multiple of the chunk
    (29, 8, False),      # ragged: padded with dt = 0
    (5, 8, False),       # shorter than one chunk
    (24, 8, True),       # with an initial state
    (21, 16, True)])
def test_ssd_chunked_matches_jax(S, chunk, init):
    xh, dt, A, Bm, Cm, h0 = _ssd_inputs(S)
    yj, hj = jmb.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), chunk,
                             initial_state=jnp.asarray(h0) if init else None)
    yt, ht = tmb.ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)),
                             chunk,
                             initial_state=torch.from_numpy(h0) if init
                             else None)
    assert yt.shape == xh.shape and ht.shape == h0.shape
    assert ht.dtype == torch.float32
    assert_close(yt.numpy(), np.asarray(yj))
    assert_close(ht.numpy(), np.asarray(hj))


def test_ssd_chunk_size_does_not_change_the_result():
    xh, dt, A, Bm, Cm, _ = _ssd_inputs(30, seed=2)
    args = tuple(map(torch.from_numpy, (xh, dt, A, Bm, Cm)))
    y1, h1 = tmb.ssd_chunked(*args, 30)
    for c in (4, 7, 16):
        y2, h2 = tmb.ssd_chunked(*args, c)
        assert_close(y2.numpy(), y1.numpy())
        assert_close(h2.numpy(), h1.numpy())


@pytest.fixture(scope="module")
def layer():
    """mamba2's SMOKE config and its first layer's params, both packages."""
    jcfg = jax_get_smoke("mamba2-1.3b")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0][0])
    # dt_bias and A_log stay f32 in both
    return jcfg, jp, port_cfg(jcfg), port_params(jp)


@pytest.mark.parametrize("S", [20, 37])
def test_mamba_forward_matches_jax(layer, S):
    jcfg, jp, cfg, p = layer
    x = _rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    yj, sj = jmb.mamba_forward(jnp.asarray(x), jp, jcfg, return_state=True)
    yt, st = tmb.mamba_forward(torch.from_numpy(x), p, cfg,
                               return_state=True)
    assert_close(yt.numpy(), np.asarray(yj))
    assert_close(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("S", [1, 2, 3, 17])
def test_mamba_prefill_cache_matches_jax(layer, S):
    """S < K - 1 (K 4) left-pads the conv tails with zeros."""
    jcfg, jp, cfg, p = layer
    x = _rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    yj, cj = jmb.mamba_prefill(jnp.asarray(x), jp, jcfg)
    cache = tmb.init_mamba_cache(cfg, 2, torch.float32)
    yt, ct = tmb.mamba_prefill(torch.from_numpy(x), p, cfg, cache)
    assert ct is cache                      # written in place
    assert_close(yt.numpy(), np.asarray(yj))
    for name in ("conv_x", "conv_B", "conv_C", "state"):
        assert ct[name].shape == cj[name].shape
        assert_close(ct[name].numpy(), np.asarray(cj[name]))
    if S < cfg.ssm_conv - 1:
        pad = cfg.ssm_conv - 1 - S
        assert not ct["conv_x"][:, :pad].any()


def test_mamba_decode_token_by_token_equals_forward(layer):
    """Prefill 5 tokens, then decode 11 one at a time: every step's output
    equals the full forward's at that position, in both packages."""
    jcfg, jp, cfg, p = layer
    S, P = 16, 5
    x = _rng(4).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    full = tmb.mamba_forward(torch.from_numpy(x), p, cfg)
    assert_close(full.numpy(), np.asarray(jmb.mamba_forward(
        jnp.asarray(x), jp, jcfg)))
    cache = tmb.init_mamba_cache(cfg, 2, torch.float32)
    state_ref = cache["state"]
    _, cache = tmb.mamba_prefill(torch.from_numpy(x[:, :P]), p, cfg, cache)
    _, jc = jmb.mamba_prefill(jnp.asarray(x[:, :P]), jp, jcfg)
    for t in range(P, S):
        yt, cache = tmb.mamba_decode(torch.from_numpy(x[:, t:t + 1]), p,
                                     cfg, cache)
        yj, jc = jmb.mamba_decode(jnp.asarray(x[:, t:t + 1]), jp, jcfg, jc)
        assert_close(yt.numpy(), np.asarray(yj))
        assert_close(yt[:, 0].numpy(), full[:, t].numpy())
        assert_close(cache["state"].numpy(), np.asarray(jc["state"]))
    assert cache["state"] is state_ref      # the same tensor throughout


def test_init_mamba_cache_dtypes():
    cfg = port_cfg(jax_get_smoke("jamba-v0.1-52b")).replace(dtype="bfloat16")
    c = tmb.init_mamba_cache(cfg, 3, torch.bfloat16)
    K = cfg.ssm_conv
    assert c["conv_x"].shape == (3, K - 1, cfg.d_inner)
    assert c["conv_B"].shape == c["conv_C"].shape == (3, K - 1,
                                                      cfg.ssm_state)
    assert c["state"].shape == (3, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state)
    assert c["conv_x"].dtype == torch.bfloat16
    assert c["state"].dtype == torch.float32
