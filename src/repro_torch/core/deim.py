"""Discrete Empirical Interpolation Method (DEIM) index selection.

Given the leading-r singular vectors V (m, r) of an importance matrix, DEIM
picks exactly r distinct row indices: index j is the position of the largest
interpolation residual of singular vector j against the previously selected
rows (Sorensen & Embree 2016, Alg. 1). The solve is the JAX package's
fixed-shape padded one (identity outside the leading j x j block), so both
packages do the same arithmetic. A leading batch dim runs several
selections at once (the batched compression pipeline).

On a CUDA device the loop's LU goes through cuSOLVER / cuBLAS and skips
the solve's error check: PyTorch's default sends a batch of systems to
MAGMA, whose batched getrf allocates and frees its device workspace on
every call (a ``cudaMalloc`` / ``cudaFree`` pair, the free a device-wide
sync), and the error check copies ``info`` to the host at every step.
The padded systems are nonsingular by construction (DEIM never picks a
row twice), and JAX's solve checks nothing either.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """cuSOLVER / cuBLAS as the preferred linear-algebra library while a
    CUDA device's loop runs (no effect on the CPU)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def deim(V: torch.Tensor) -> torch.Tensor:
    """V: (..., m, r) orthonormal-ish columns. Returns (..., r) distinct
    int64 indices."""
    V = V.float()
    lead = V.shape[:-2]
    m, r = V.shape[-2:]
    Vb = V.reshape(-1, m, r)
    k = Vb.shape[0]
    ar = torch.arange(k, device=V.device)
    jr = torch.arange(r, device=V.device)
    p = torch.zeros((k, r), dtype=torch.long, device=V.device)
    p0 = torch.argmax(torch.abs(Vb[:, :, 0]), dim=-1)
    p[:, 0] = p0
    visited = torch.zeros((k, m), dtype=torch.bool, device=V.device)
    visited[ar, p0] = True
    with _cusolver(V.device):
        for j in range(1, r):
            rows = Vb[ar[:, None], p]                    # (k, r, r)
            mask = jr < j
            sq = mask[:, None] & mask[None, :]
            A = torch.where(sq, rows, torch.zeros_like(rows))
            A = A + torch.diag((~mask).float())          # identity padding
            rhs = torch.where(mask, rows[:, :, j],
                              torch.zeros_like(rows[:, :, j]))
            c = torch.linalg.solve_ex(A, rhs).result     # zeros beyond j
            c = torch.where(mask, c, torch.zeros_like(c))
            res = Vb[:, :, j] - (Vb @ c[..., None])[..., 0]
            score = torch.where(visited, torch.full_like(res, -1.0),
                                torch.abs(res))
            pj = torch.argmax(score, dim=-1)
            p[:, j] = pj
            visited[ar, pj] = True
    return p.reshape(*lead, r)

