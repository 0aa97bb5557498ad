"""Port parity for the CURing core: Eq. 2 ranks, WANDA, DEIM, the SVDs,
CUR extraction, Theorem 3.1 bound, angular layer selection and index
selection. Integer outputs must match the JAX package exactly; floats are
held to 2e-5 scale-relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import angular as jang
from repro.core import cur as jcur
from repro.core.compress import select_indices as jax_select_indices
from repro.core.deim import deim as jax_deim
from repro.core.wanda import wanda_scores as jax_wanda
from repro_torch.core import angular as tang
from repro_torch.core import cur as tcur
from repro_torch.core.compress import select_indices
from repro_torch.core.deim import deim
from repro_torch.core.wanda import wanda_scores

from _torch_helpers import assert_close

torch.set_num_threads(1)


def _lowrank(m, n, seed, decay=0.7, noise=1e-3):
    """A matrix with a well-separated, geometrically decaying spectrum."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, k)))
    V, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = decay ** np.arange(k)
    W = (U * s) @ V.T + noise * rng.standard_normal((m, n))
    return W.astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("m,n,r_max", [
    (4096, 4096, 256), (4096, 1024, 256), (4096, 14336, 256),
    (64, 64, 32), (64, 32, 16), (64, 160, 8), (3, 2, 256), (1, 1, 4),
    (256, 704, 1024)])
def test_rank_for_matches_jax(m, n, r_max):
    assert tcur.rank_for(m, n, r_max) == jcur.rank_for(m, n, r_max)


def test_wanda_scores_match_jax():
    rng = np.random.default_rng(0)
    W = rng.standard_normal((48, 40), dtype=np.float32)
    a = np.abs(rng.standard_normal((48,), dtype=np.float32)) * 10
    a[3] = -1.0                                      # clamped to 0
    assert_close(_np(wanda_scores(torch.from_numpy(W), torch.from_numpy(a))),
                 jax_wanda(jnp.asarray(W), jnp.asarray(a)))


@pytest.mark.parametrize("m,r,seed", [(64, 8, 1), (96, 16, 2), (40, 40, 3)])
def test_deim_matches_jax(m, r, seed):
    W = _lowrank(m, 48 if m != 40 else 40, seed)
    P = np.linalg.svd(W.astype(np.float64))[0][:, :r].astype(np.float32)
    pj = np.asarray(jax_deim(jnp.asarray(P)))
    pt = _np(deim(torch.from_numpy(P)))
    np.testing.assert_array_equal(pt, pj)
    assert len(set(pt.tolist())) == r


def test_deim_batched_equals_per_matrix():
    Ps = np.stack([np.linalg.svd(_lowrank(64, 48, s))[0][:, :12]
                   for s in range(4)]).astype(np.float32)
    batched = _np(deim(torch.from_numpy(Ps)))
    for i in range(4):
        np.testing.assert_array_equal(
            batched[i], _np(deim(torch.from_numpy(Ps[i]))))


def _reconstruct(P, sig, Q):
    return (np.asarray(P) * np.asarray(sig)) @ np.asarray(Q).T


def test_exact_svd_matches_jax():
    W = _lowrank(64, 48, 4)
    Pj, sj, Qj = jcur.exact_svd(jnp.asarray(W), 9)
    Pt, st, Qt = tcur.exact_svd(torch.from_numpy(W), 9)
    assert_close(_np(st), sj)
    assert_close(_reconstruct(_np(Pt), _np(st), _np(Qt)),
                 _reconstruct(Pj, sj, Qj))


def test_randomized_svd_with_injected_g_matches_jax():
    W = _lowrank(80, 64, 5)
    r = 9
    key = jax.random.PRNGKey(11)
    k = min(r + 8, 64)
    G = np.array(jax.random.normal(key, (64, k), jnp.float32))
    Pj, sj, Qj = jcur.randomized_svd(jnp.asarray(W), r, key)
    Pt, st, Qt = tcur.randomized_svd(torch.from_numpy(W), r,
                                     G=torch.from_numpy(G))
    assert_close(_np(st), sj)
    assert_close(_reconstruct(_np(Pt), _np(st), _np(Qt)),
                 _reconstruct(Pj, sj, Qj))


def test_cur_from_indices_matches_jax():
    W = _lowrank(64, 48, 6)
    p = np.array([3, 10, 17, 40, 63, 1], np.int64)
    q = np.array([0, 5, 11, 30, 47, 2], np.int64)
    Cj, Uj, Rj = jcur.cur_from_indices(jnp.asarray(W), jnp.asarray(p),
                                       jnp.asarray(q))
    Ct, Ut, Rt = tcur.cur_from_indices(torch.from_numpy(W),
                                       torch.from_numpy(p),
                                       torch.from_numpy(q))
    np.testing.assert_array_equal(_np(Ct), np.asarray(Cj))
    np.testing.assert_array_equal(_np(Rt), np.asarray(Rj))
    assert_close(_np(Ct @ Ut @ Rt), Cj @ Uj @ Rj)


def test_spectral_error_bound_matches_jax():
    W = _lowrank(64, 48, 7)
    r = 8
    P, sig, Qt = np.linalg.svd(W)
    P, sig, Q = (P[:, :r + 1].astype(np.float32),
                 sig[:r + 1].astype(np.float32),
                 Qt[:r + 1].T.astype(np.float32))
    p = np.array(jax_deim(jnp.asarray(P[:, :r])))
    q = np.array(jax_deim(jnp.asarray(Q[:, :r])))
    bj = float(jcur.spectral_error_bound(
        jnp.asarray(P[:, :r]), jnp.asarray(Q[:, :r]), jnp.asarray(sig),
        jnp.asarray(p), jnp.asarray(q)))
    bt = float(tcur.spectral_error_bound(
        torch.from_numpy(P[:, :r]), torch.from_numpy(Q[:, :r]),
        torch.from_numpy(sig), torch.from_numpy(p).long(),
        torch.from_numpy(q).long()))
    assert np.isfinite(bt) and abs(bt - bj) / abs(bj) < 2e-5
    inf = tcur.spectral_error_bound(
        torch.from_numpy(P[:, :r]), torch.from_numpy(Q[:, :r]),
        torch.from_numpy(sig[:r]), torch.from_numpy(p).long(),
        torch.from_numpy(q).long())
    assert float(inf) == float("inf")


@pytest.mark.parametrize("method", ["wanda_deim", "wanda", "deim",
                                    "weight"])
def test_select_indices_matches_jax(method):
    W = _lowrank(64, 96, 8)
    act = np.abs(np.random.default_rng(9).standard_normal(64)).astype(
        np.float32) * 50
    pj, qj, _ = jax_select_indices(jnp.asarray(W), 16, method,
                                   jnp.asarray(act), jax.random.PRNGKey(0),
                                   "exact")
    pt, qt, _ = select_indices(torch.from_numpy(W), 16, method,
                               torch.from_numpy(act), 0, "exact")
    np.testing.assert_array_equal(_np(pt), np.asarray(pj))
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))


def test_select_indices_random_is_seeded_and_distinct():
    W = torch.from_numpy(_lowrank(64, 96, 10))
    p1, q1, _ = select_indices(W, 16, "random", None, 5)
    p2, q2, _ = select_indices(W, 16, "random", None, 5)
    assert torch.equal(p1, p2) and torch.equal(q1, q2)
    assert len(set(p1.tolist())) == 16 and len(set(q1.tolist())) == 16
    assert int(p1.max()) < 64 and int(q1.max()) < 96


def test_select_indices_batched_equals_single():
    Ws = torch.stack([torch.from_numpy(_lowrank(64, 96, s))
                      for s in range(3)])
    acts = torch.rand(3, 64, generator=torch.Generator().manual_seed(0))
    for svd in ("exact", "randomized"):
        pb, qb, _ = select_indices(Ws, 8, "wanda_deim", acts, [4, 5, 6],
                                   svd)
        for i in range(3):
            p, q, _ = select_indices(Ws[i], 8, "wanda_deim", acts[i], 4 + i,
                                     svd)
            assert torch.equal(pb[i], p) and torch.equal(qb[i], q)


def test_layer_selection_matches_jax():
    rng = np.random.default_rng(12)
    hidden = rng.standard_normal((7, 5, 32)).astype(np.float32)
    hidden[3] = hidden[2] + 0.01 * hidden[3]           # a redundant block
    dj = jang.layer_distances(jnp.asarray(hidden))
    dt = tang.layer_distances(hidden)
    # scale-relative, as every float here: arccos near 0 turns f32
    # rounding of cos into a large elementwise relative spread
    assert_close(dt, dj)
    for method in ("angular", "last", "random"):
        assert tang.select_layers(dt, 3, method, 1) == \
            jang.select_layers(dj, 3, method, 1)
