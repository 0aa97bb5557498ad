"""CUR decomposition: rank selection (Eq. 2), the Frobenius-optimal link
matrix U = C+ W R+ (Eq. 1), randomized range-finder SVD, and the
error-bound constants of Theorem 3.1.

Every function takes an optional leading batch dim (the batched
compression pipeline stacks same-shape weights).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


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


def exact_svd(S: torch.Tensor, r: int):
    """Leading-r SVD via the full SVD (paper-faithful path).
    Returns (P (..., m, r), sig (..., r), Q (..., n, r))."""
    P, sig, Qt = torch.linalg.svd(S.float(), full_matrices=False)
    return P[..., :, :r], sig[..., :r], Qt[..., :r, :].mT


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
