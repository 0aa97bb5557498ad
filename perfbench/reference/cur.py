"""Plain PyTorch CURing (the paper's §4), written from its equations for
the benchmark's check: calibration statistics, WANDA importance, the
exact SVD, DEIM index selection, the link matrix U = C+ W R+ and the
fold C' = C U; and what the check measures the program's stages with.

Float32 (DEIM and the SVD's check in float64); imports nothing of the
program, of the JAX package or of ``jax``. ``quant="fp8"`` is the
control: each stage hands the next its output rounded to float8 e4m3
(absmax-scaled), and DEIM ranks its residuals rounded alike, the
precision step below the configurations' bfloat16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

from reference import model as ref

MIXER_TARGETS = ("wq", "wk", "wv")
MLP_TARGETS = ("w_gate", "w_up")


@torch.no_grad()
def calibrate(tokens: torch.Tensor, layer: Callable[[int], Dict],
              embed: torch.Tensor, m: Dict, targets: Sequence[str]):
    """One float32 forward of a dense stage over calibration rows
    ``tokens`` (B, S). Returns [per layer {target: (m,) sum over the rows
    of the target's squared inputs}]."""
    x = embed[tokens].float()                          # (B, S, D)
    act: List[Dict[str, torch.Tensor]] = []
    eps = m["rms_norm_eps"]
    for li in range(m["num_hidden_layers"]):
        p = layer(li)
        a = {}
        h1 = ref.rms_norm(x, p["norm1"], eps)
        for t in targets:
            if t in MIXER_TARGETS:
                a[t] = (h1 ** 2).sum(dim=(0, 1))
        x = x + torch.stack([ref.attention(h, p, m) for h in h1])
        h2 = ref.rms_norm(x, p["norm2"], eps)
        for t in targets:
            if t in MLP_TARGETS:
                a[t] = (h2 ** 2).sum(dim=(0, 1))
        x = x + ref.mlp(h2, p)
        act.append(a)
    return act


def rank_for(m: int, n: int, r_max: int) -> int:
    """The paper's Eq. 2: the largest power of two r with m r + r^2 + r n
    < m n, capped at r_max."""
    r_star = (math.sqrt(m * m + 6 * m * n + n * n) - (m + n)) / 2.0
    if r_star < 1:
        return 1
    return min(2 ** int(math.floor(math.log2(r_star))), r_max)


def wanda(W: torch.Tensor, act_sq: torch.Tensor) -> torch.Tensor:
    """S_ij = |W_ij| ||X_i|| (y = x W: activations scale rows)."""
    return W.abs() * act_sq.clamp(min=0).sqrt()[:, None]


def deim(V: torch.Tensor, picks: Optional[Sequence[int]] = None,
         quant: Optional[str] = None):
    """Sorensen & Embree's DEIM on V (m, r), in float64: index j is where
    singular vector j's interpolation residual against the rows picked
    so far is largest. Returns (picks, shortfall). Given ``picks`` (the
    program's), it follows them and measures instead: shortfall is the
    worst, over the steps, of how far the residual at the given pick lies
    below the largest among the rows not yet picked, over that largest
    (0 for a sound DEIM up to rounding; 2 for a row picked twice)."""
    V = V.double()
    m, r = V.shape
    given = picks is not None
    if given:
        picks = [int(i) for i in picks]
        if len(set(picks)) < len(picks) or len(picks) != r:
            return picks, 2.0
    out: List[int] = []
    short = []
    for j in range(r):
        if j == 0:
            res = V[:, 0].abs()
        else:
            idx = torch.tensor(out, device=V.device)
            c = torch.linalg.solve(V[idx, :j], V[idx, j])
            res = (V[:, j] - V[:, :j] @ c).abs()
            res[idx] = -1.0
        if quant == "fp8":
            res = ref.fp8_round(res.float(), 0).double()
        top = res.max()
        if given:
            short.append((top - res[picks[j]]) / top)
            out.append(picks[j])
        else:
            out.append(int(torch.argmax(res)))
    if not given:
        return out, 0.0
    return out, float(torch.stack(short).max())


def pinv(A: torch.Tensor) -> torch.Tensor:
    rtol = 10.0 * max(A.shape) * torch.finfo(A.dtype).eps
    return torch.linalg.pinv(A, rtol=rtol)


def fold_at(W: torch.Tensor, rows, cols) -> torch.Tensor:
    """C U with C = W[:, cols], U = C+ W R+, R = W[rows, :]."""
    C = W[:, cols]
    return C @ (pinv(C) @ W @ pinv(W[rows, :]))


def svd_shortfall(S, P, sig, Q, gen: torch.Generator,
                  iters: int = 4, block: int = 8):
    """How far (P, sig, Q) (k triplets) are from the leading singular
    triplets of S, in float64, over sig[0]. Returns (shortfall, orth):
    shortfall is the larger of the residuals of S Q = P diag(sig) and
    S^T P = Q diag(sig) (over sqrt k) and of how far the deflated
    S - P diag(sig) Q^T reaches above sig[-1] (a few steps of subspace
    iteration from a Gaussian block drawn from ``gen``); orth is the
    departure of P and Q from orthonormal columns."""
    S, P, sig, Q = (t.double() for t in (S, P, sig, Q))
    k = sig.shape[0]
    top = sig[0]
    res = max(torch.linalg.norm(S @ Q - P * sig),
              torch.linalg.norm(S.T @ P - Q * sig)) / (top * math.sqrt(k))
    eye = torch.eye(k, dtype=S.dtype, device=S.device)
    orth = max((P.T @ P - eye).abs().max(), (Q.T @ Q - eye).abs().max())

    def defl(X):
        return S @ X - P @ (sig[:, None] * (Q.T @ X))

    def defl_t(Y):
        return S.T @ Y - Q @ (sig[:, None] * (P.T @ Y))
    X = torch.randn((S.shape[1], block), generator=gen, device=S.device,
                    dtype=torch.float32).double()
    for _ in range(iters):
        X, _ = torch.linalg.qr(defl_t(defl(X)))
    reach = torch.linalg.svdvals(defl(X))[0]
    above = (reach - sig[-1]).clamp(min=0) / top
    return float(max(res, above)), float(orth)


def cur_weight(W: torch.Tensor, act_sq: torch.Tensor, r: int,
               quant: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """WANDA x DEIM CUR of W (m, n), folded, with every stage's output
    kept: S, the leading r + 1 singular triplets (P, sig, Q), the rows p
    and columns q, C U (m, r) and R (r, n)."""
    q8 = (lambda t: ref.fp8_round(t, 0)) if quant == "fp8" else (lambda t: t)
    W = q8(W)
    S = q8(wanda(W, act_sq))
    k = min(r + 1, *S.shape)
    # QR-based gesvd on a card: the default there, Jacobi, stops short
    Pf, sig, Qt = torch.linalg.svd(S, full_matrices=False,
                                   driver="gesvd" if S.is_cuda else None)
    P, sig, Q = q8(Pf[:, :k]), sig[:k], q8(Qt[:k].T)
    p, _ = deim(P[:, :r], quant=quant)
    q, _ = deim(Q[:, :r], quant=quant)
    return {"S": S, "P": P, "sig": sig, "Q": Q, "p": p, "q": q,
            "CU": q8(fold_at(W, p, q)), "R": W[p, :]}
