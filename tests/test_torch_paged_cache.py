"""The port's paged cache against the JAX package's: the host allocator
(same op sequence -> same ids, refcounts, copy-on-write and window holes),
the pool writes and reads (bit-equal, every drop case included), and the
CUR-KV column selection on separated-spectrum fixtures (same DEIM indices,
U within 2e-5 scale-relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import paged_cache as jpc
from repro_torch.serving import paged_cache as tpc

from _torch_helpers import assert_close, port_cfg
from test_compress import _structured_lowrank

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# host allocator
# ---------------------------------------------------------------------------

def _alloc_state(a):
    return (list(a._free), dict(a._ref), a.n_free, a.used,
            a.blocks_freed_window, list(a._squeezed))


def _drive(mod):
    """One op sequence through ``mod.BlockAllocator``; returns every
    result and the state after each op."""
    a = mod.BlockAllocator(12)
    log = []

    def rec(out):
        log.append((out, _alloc_state(a)))

    x = a.alloc(3)
    rec(x)
    y = a.alloc(4)
    rec(y)
    rec(a.fork(x))
    rec(a.copy_on_write(x[1]))            # shared -> fresh private block
    rec(a.copy_on_write(y[0]))            # exclusive -> itself
    a.free(x)
    rec(None)
    rec(a.alloc(20))                      # dry pool -> None
    row = list(y) + a.alloc(2)
    rec(a.free_window(row, ctx_len=23, window=6, block_size=4))
    rec(list(row))                        # -1 holes where blocks were freed
    rec(a.squeeze(3))
    rec(a.alloc(a.n_free))
    rec(a.release_squeeze())
    with pytest.raises(ValueError, match="double free"):
        a.free([row[0]] if row[0] >= 0 else [99])
    with pytest.raises(ValueError, match="unallocated"):
        a.fork([99])
    return log


def test_allocator_same_ops_same_state():
    assert _drive(tpc) == _drive(jpc)


def test_paged_config_matches():
    for kw in ({}, {"cur_kv": True, "kv_rank": 8}):
        jc = jpc.PagedConfig.sized_for(100, 4, block_size=8, **kw)
        tc = tpc.PagedConfig.sized_for(100, 4, block_size=8, **kw)
        assert (jc.n_blocks, jc.max_blocks_per_seq, jc.max_len,
                jc.blocks_for(33), jc.rank(16)) == \
            (tc.n_blocks, tc.max_blocks_per_seq, tc.max_len,
             tc.blocks_for(33), tc.rank(16))


def test_cache_layout_matches(tiny_cfg):
    cfg = port_cfg(tiny_cfg)
    for kw in ({}, {"cur_kv": True, "kv_rank": 8}):
        pc = tpc.PagedConfig(block_size=4, n_blocks=6, max_blocks_per_seq=3,
                             **kw)
        jc = jpc.init_paged_cache(tiny_cfg, jpc.PagedConfig(**vars(pc)))
        tc = tpc.init_paged_cache(cfg, pc, "cpu")
        assert tuple(tc["k"].shape) == jc["k"].shape
        assert tpc.cache_bytes(tc) == jpc.cache_bytes(jc)
        assert tpc._attn_layers(cfg) == jpc._attn_layers(tiny_cfg)
        assert tpc.supports(cfg) and tpc.serving_window(cfg) == 0
        if kw:
            for name in ("qk", "uk", "qv", "uv"):
                np.testing.assert_array_equal(
                    tc["proj"][name].numpy(), np.asarray(jc["proj"][name]))


# ---------------------------------------------------------------------------
# pool writes / reads
# ---------------------------------------------------------------------------

NB, BS, K, R, MAXB = 6, 4, 2, 3, 3


def _pool(seed):
    return np.random.RandomState(seed).standard_normal(
        (NB, BS, K, R)).astype(np.float32)


# -1 holes, a row past the table width, rows past their length
_TABLE = np.array([[2, -1, 4], [0, 1, -1], [-1, -1, -1], [5, 3, -1]],
                  np.int32)


def _check(jout, tout):
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_write_prompt_bit_equal():
    S = 16                                  # past the table's 12 positions
    x = np.random.RandomState(1).standard_normal(
        (4, S, K, R)).astype(np.float32)
    lengths = np.array([11, 7, 5, 16], np.int32)
    pool = _pool(0)
    j = jpc.write_prompt(jnp.asarray(pool), jnp.asarray(x),
                         jnp.asarray(_TABLE), jnp.asarray(lengths), BS)
    t = tpc.write_prompt(torch.from_numpy(pool.copy()), torch.from_numpy(x),
                         torch.from_numpy(_TABLE), torch.from_numpy(lengths),
                         BS)
    _check(j, t)
    assert not np.array_equal(np.asarray(j), pool)


def test_write_token_bit_equal():
    x = np.random.RandomState(2).standard_normal((4, K, R)).astype(
        np.float32)
    for pos, active in [
            ([3, 5, 0, 9], [True, True, True, True]),     # hole, -1 row
            ([13, 2, 1, 12], [True, False, True, True]),  # past the width
            ([0, 4, 7, 6], [False, True, False, True])]:
        pool = _pool(3)
        pos, active = np.array(pos, np.int32), np.array(active)
        j = jpc.write_token(jnp.asarray(pool), jnp.asarray(x),
                            jnp.asarray(_TABLE), jnp.asarray(pos),
                            jnp.asarray(active), BS)
        t = tpc.write_token(torch.from_numpy(pool.copy()),
                            torch.from_numpy(x), torch.from_numpy(_TABLE),
                            torch.from_numpy(pos), torch.from_numpy(active),
                            BS)
        _check(j, t)


def test_write_span_bit_equal():
    S = 5
    x = np.random.RandomState(4).standard_normal((4, S, K, R)).astype(
        np.float32)
    for start, active in [([2, 6, 0, 9], [True, True, True, True]),
                          ([10, 1, 3, 4], [True, True, False, True])]:
        pool = _pool(5)
        start, active = np.array(start, np.int32), np.array(active)
        j = jpc.write_span(jnp.asarray(pool), jnp.asarray(x),
                           jnp.asarray(_TABLE), jnp.asarray(start),
                           jnp.asarray(active), BS)
        t = tpc.write_span(torch.from_numpy(pool.copy()),
                           torch.from_numpy(x), torch.from_numpy(_TABLE),
                           torch.from_numpy(start), torch.from_numpy(active),
                           BS)
        _check(j, t)


def test_copy_cache_blocks_bit_equal():
    rng = np.random.RandomState(6)
    k = rng.standard_normal((2, NB, BS, K, R)).astype(np.float32)
    v = rng.standard_normal((2, NB, BS, K, R)).astype(np.float32)
    # a copy, a drop sentinel (dst = n_blocks), a clamped src
    src = np.array([1, 4, 9, 2], np.int32)
    dst = np.array([3, NB, 5, NB + 2], np.int32)
    j = jpc.copy_cache_blocks({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                              jnp.asarray(src), jnp.asarray(dst))
    t = tpc.copy_cache_blocks(
        {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())},
        torch.from_numpy(src), torch.from_numpy(dst))
    _check(j["k"], t["k"])
    _check(j["v"], t["v"])


def test_gather_kv_and_compress_bit_equal():
    pool = _pool(7)
    _check(jpc.gather_kv(jnp.asarray(pool), jnp.asarray(_TABLE)),
           tpc.gather_kv(torch.from_numpy(pool), torch.from_numpy(_TABLE)))
    x = np.random.RandomState(8).standard_normal((2, 5, 16)).astype(
        np.float32)
    q = np.array([1, 4, 9, 15], np.int32)
    _check(jpc.compress_kv(jnp.asarray(x), jnp.asarray(q)),
           tpc.compress_kv(torch.from_numpy(x), torch.from_numpy(q)))
    U = np.random.RandomState(9).standard_normal((4, 16)).astype(np.float32)
    xr = x[..., :4]
    assert_close(tpc.reconstruct_kv(torch.from_numpy(xr),
                                    torch.from_numpy(U)).numpy(),
                 np.asarray(jpc.reconstruct_kv(jnp.asarray(xr),
                                               jnp.asarray(U))))


# ---------------------------------------------------------------------------
# CUR-KV column selection
# ---------------------------------------------------------------------------

def _separated(N, hd, seed):
    """A (N, hd) matrix whose singular values are evenly apart, from 1
    down to 1/2 (well conditioned: an f32 pinv of a steeper spectrum,
    condition ~3e4, differs by ~5e-5 between two LAPACK paths whatever
    the port does)."""
    rng = np.random.RandomState(seed)
    P, _ = np.linalg.qr(rng.standard_normal((N, hd)))
    Q, _ = np.linalg.qr(rng.standard_normal((hd, hd)))
    s = 1.0 - np.arange(hd) / (2 * hd)
    return ((P * s) @ Q.T).astype(np.float32)


def _fixtures(tiny_cfg, tiny_params):
    """Separated spectra: an evenly spaced one, and the structured
    low-rank weights of tests/test_compress.py (rows of wk / wv as
    (N, hd))."""
    mats = [_separated(128, 16, 0), _separated(64, 32, 1)]
    sp = _structured_lowrank(tiny_params, tiny_cfg)
    block = sp["groups"][0][0]
    for name in ("wk", "wv"):
        w = np.asarray(jax.device_get(block[name][0]), np.float32)
        mats.append(w.reshape(-1, tiny_cfg.resolved_head_dim).copy())
    return mats


@pytest.mark.parametrize("r", [8, 16])
def test_kv_projection_matches_jax(tiny_cfg, tiny_params, r):
    for mat in _fixtures(tiny_cfg, tiny_params):
        qj, Uj = jpc.kv_projection(jnp.asarray(mat), r)
        qt, Ut = tpc.kv_projection(torch.from_numpy(mat.copy()), r)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert_close(Ut.numpy(), np.asarray(Uj))


def test_projections_from_kv_matches_jax(tiny_cfg, tiny_params):
    mats = _fixtures(tiny_cfg, tiny_params)[2:]
    hd = tiny_cfg.resolved_head_dim
    ks = [m.reshape(1, -1, 2, hd) for m in mats]
    vs = [m[::-1].copy().reshape(1, -1, 2, hd) for m in mats]
    pj = jpc.projections_from_kv([jnp.asarray(k) for k in ks],
                                 [jnp.asarray(v) for v in vs], 8)
    pt = tpc.projections_from_kv([torch.from_numpy(k) for k in ks],
                                 [torch.from_numpy(v) for v in vs], 8)
    for name in ("qk", "qv"):
        np.testing.assert_array_equal(pt[name].numpy(), np.asarray(pj[name]))
    for name in ("uk", "uv"):
        assert_close(pt[name].numpy(), np.asarray(pj[name]))
