"""CUR decomposition: rank selection (Eq. 2), the Frobenius-optimal link
matrix U = C+ W R+ (Eq. 1), the exact leading SVD, randomized
range-finder SVD, and the error-bound constants of Theorem 3.1.

Every function takes an optional leading batch dim (the batched
compression pipeline stacks same-shape weights).
"""
from __future__ import annotations

import contextvars
import math
from typing import Optional

import torch

from repro_torch.obs import metrics as obs_metrics

# sigma_k / sigma_1 below which the Gram route hands over to the full SVD:
# the float64 Gram's eigenvalues carry an error of about n eps64 sigma_1^2,
# which resolves sigma_k to float32's resolution of sigma_1 only down to
# here (a rank-deficient score, e.g. dead input features, falls below)
GRAM_FLOOR = 1e-4
# the route ("gram" | "full") of this context's last exact_svd call, for
# its caller's span: the return stays (P, sig, Q)
svd_route: contextvars.ContextVar = contextvars.ContextVar(
    "svd_route", default=None)


def rank_for(m: int, n: int, r_max: int = 256) -> int:
    """Paper Eq. 2: largest power-of-2 rank that still reduces parameters,
    capped at r_max. Solves mr + r^2 + rn < mn."""
    r_star = (math.sqrt(m * m + 6 * m * n + n * n) - (m + n)) / 2.0
    if r_star < 1:
        return 1
    r = 2 ** int(math.floor(math.log2(r_star)))
    return min(r, r_max)


def pinv(A: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse with the JAX package's cutoff:
    rtol = 10 * max(rows, cols) * eps."""
    rtol = 10.0 * max(A.shape[-2:]) * torch.finfo(A.dtype).eps
    return torch.linalg.pinv(A, rtol=rtol)


def compute_u(W: torch.Tensor, C: torch.Tensor, R: torch.Tensor
              ) -> torch.Tensor:
    """U = pinv(C) @ W @ pinv(R) — optimal in Frobenius norm given C, R."""
    return pinv(C.float()) @ W.float() @ pinv(R.float())


def _gram_svd(S: torch.Tensor, k: int):
    """The k leading triplets from the float64 Gram matrix of the smaller
    side, or None where sigma_k < GRAM_FLOOR sigma_1 (one readback)."""
    S = S.double()                               # exact cast
    wide = S.shape[-2] <= S.shape[-1]
    G = S @ S.mT if wide else S.mT @ S
    lam, V = torch.linalg.eigh(G)                # ascending
    V = V[..., -k:].flip(-1)
    sig = lam[..., -k:].flip(-1).clamp(min=0).sqrt()
    if not bool((sig[..., -1] > GRAM_FLOOR * sig[..., 0]).all()):
        return None
    W = (S.mT @ V if wide else S @ V) / sig[..., None, :]
    P, Q = (V, W) if wide else (W, V)
    return P.float(), sig.float(), Q.float()


def exact_svd(S: torch.Tensor, r: int):
    """The leading r singular triplets of S, converged.
    Returns (P (..., m, r), sig (..., r), Q (..., n, r)), float32.

    For r < min(m, n) (route "gram"): the r largest eigenpairs of the
    float64 Gram matrix of the smaller side (S S^T when m <= n, else
    S^T S) give sig = sqrt(lambda) and that side's vectors, orthonormal
    to float64 rounding; one float64 back-product gives the other side's
    (Q = S^T P diag(1/sig)). That is O(mn min(m, n)) in products plus one
    min(m, n)^2 eigensolve, against a full SVD's iterations over all
    min(m, n) triplets. The full SVD (route "full") answers where the
    Gram cannot hold the answer: r = min(m, n), or sigma_r below
    GRAM_FLOOR sigma_1 in some matrix of the batch. Each call counts in
    ``repro_cur_svd_calls_total{route}`` and sets ``svd_route``."""
    out = _gram_svd(S, r) if r < min(S.shape[-2:]) else None
    route = "full" if out is None else "gram"
    if out is None:
        P, sig, Qt = torch.linalg.svd(S.float(), full_matrices=False)
        out = P[..., :, :r], sig[..., :r], Qt[..., :r, :].mT
    svd_route.set(route)
    obs_metrics.counter(
        "repro_cur_svd_calls_total", "exact_svd calls by route",
        labels=("route",)).labels(route=route).inc()
    return out


def randomized_svd(S: torch.Tensor, r: int,
                   generator: Optional[torch.Generator] = None,
                   oversample: int = 8, n_iter: int = 2,
                   G: Optional[torch.Tensor] = None):
    """Halko randomized range-finder SVD: tall-skinny products + QR + a
    small SVD, O(mnr) instead of O(mn min(m,n)). The Gaussian test matrix
    G (..., n, k), k = min(r + oversample, min(m, n)), is drawn from
    ``generator`` unless given (the tests inject JAX's)."""
    S = S.float()
    m, n = S.shape[-2:]
    k = min(r + oversample, min(m, n))
    if G is None:
        G = torch.randn((*S.shape[:-2], n, k), generator=generator,
                        dtype=torch.float32, device=S.device)
    Y = S @ G.to(S.device, torch.float32)
    Q, _ = torch.linalg.qr(Y)
    for _ in range(n_iter):
        Z = S.mT @ Q
        Q, _ = torch.linalg.qr(S @ Z)
    B = Q.mT @ S                                   # (k, n)
    Ub, sig, Qt = torch.linalg.svd(B, full_matrices=False)
    P = Q @ Ub
    return P[..., :, :r], sig[..., :r], Qt[..., :r, :].mT


def take_rows(W: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """W[..., p, :] with a per-batch index p (..., r)."""
    return torch.take_along_dim(W, p[..., :, None], dim=-2)


def take_cols(W: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """W[..., :, q] with a per-batch index q (..., r)."""
    return torch.take_along_dim(W, q[..., None, :], dim=-1)


def cur_from_indices(W: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """Extract C = W[:, q], R = W[p, :], U = C+ W R+."""
    C = take_cols(W, q)
    R = take_rows(W, p)
    U = compute_u(W, C, R)
    return C, U, R


def cur_error_constants(P: torch.Tensor, Q: torch.Tensor,
                        p: torch.Tensor, q: torch.Tensor):
    """eta_p = ||(P[p,:])^-1||_2, eta_q = ||(Q[q,:])^-1||_2 (Theorem 3.1)."""
    def inv_norm(M):
        s = torch.linalg.svdvals(M)
        return 1.0 / torch.clamp(s[..., -1], min=1e-30)
    return inv_norm(take_rows(P, p)), inv_norm(take_rows(Q, q))


def spectral_error_bound(P, Q, sig, p, q):
    """(eta_p + eta_q) * sigma_{r+1} — the Theorem 3.1 upper bound on
    ||M - C U R||_2 for the matrix M whose leading singular vectors are
    (P, Q) and whose singular values are ``sig`` (at least r+1 of them).
    Only valid for the matrix that was decomposed (see
    ``WeightInfo.bound_on``)."""
    r = p.shape[-1]
    if sig.shape[-1] <= r:
        return torch.full(sig.shape[:-1], float("inf"), device=sig.device)
    eta_p, eta_q = cur_error_constants(P, Q, p, q)
    return (eta_p + eta_q) * sig[..., r]
