"""Discrete Empirical Interpolation Method (DEIM) index selection.

Given the leading-r singular vectors V (m, r) of an importance matrix, DEIM
picks exactly r distinct row indices: index j is the position of the largest
interpolation residual of singular vector j against the previously selected
rows (Sorensen & Embree 2016, Alg. 1). A leading batch dim runs several
selections at once (the batched compression pipeline).

The residuals come from Gaussian elimination with partial pivoting on a
float32 working copy R of V, one rank-1 update of R's trailing columns a
pick. After j elimination steps column j of R is the Schur complement
``v_j - V[:, :j] (V[p, :j])^-1 v_j[p]``, which is the interpolation
residual the JAX package solves the identity-padded r x r system for at
every step, and DEIM's pick is its partial pivot: the largest entry among
the rows not yet picked (Chaturantabut & Sorensen 2010, Sec. 3.1;
Sorensen & Embree 2016, Sec. 2). So the picks are the padded solve's, at
O(m r^2) a call against its O(r^4). The update is elementwise, so column
l's arithmetic reads only columns <= l: ``deim(V[..., :r]) ==
deim(V)[..., :r]`` bit for bit, and a batched call equals per-matrix calls.

A zero pivot (impossible for orthonormal V in exact arithmetic; a zero or
repeated column gives one) leaves the trailing columns as they are rather
than dividing by zero, and the picked rows stay out of every later argmax,
so the picks stay distinct. Each call counts in
``repro_cur_deim_calls_total{pivot="nonzero"|"zero"}`` ("zero" where some
matrix of the batch met one), with one readback while the registry is on.
"""
from __future__ import annotations

import torch

from repro_torch.obs import metrics as obs_metrics


def deim(V: torch.Tensor) -> torch.Tensor:
    """V: (..., m, r) orthonormal-ish columns. Returns (..., r) distinct
    int64 indices."""
    lead = V.shape[:-2]
    m, r = V.shape[-2:]
    # R[:, l] is column l of V, eliminated in place: (k, r, m)
    R = V.reshape(-1, m, r).mT.to(torch.float32, copy=True,
                                  memory_format=torch.contiguous_format)
    k = R.shape[0]
    visited = torch.zeros((k, m), dtype=torch.bool, device=V.device)
    met = (torch.zeros((k, 1), dtype=torch.bool, device=V.device)
           if obs_metrics.enabled() else None)
    picks = []
    for j in range(r):
        res = R[:, j]
        pj = torch.argmax(res.abs().masked_fill_(visited, -1.0), dim=-1,
                          keepdim=True)                  # (k, 1)
        picks.append(pj)
        visited.scatter_(1, pj, True)
        # the pivot row from column j on: (k, r - j)
        row = R[:, j:].gather(2, pj[:, None].expand(k, r - j, 1))[..., 0]
        zero = row[:, :1] == 0
        if met is not None:
            met |= zero
        if j + 1 < r:
            f = torch.where(zero, 0.0, row[:, 1:] / row[:, :1])
            R[:, j + 1:].sub_(f[:, :, None] * res[:, None, :])
    if met is not None:
        obs_metrics.counter(
            "repro_cur_deim_calls_total", "deim calls by pivot",
            labels=("pivot",)).labels(
                pivot="zero" if bool(met.any()) else "nonzero").inc()
    return torch.cat(picks, dim=-1).reshape(*lead, r)
