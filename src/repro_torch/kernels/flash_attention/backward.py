"""The backward of flash attention, in PyTorch ops.

The JAX package has no backward kernel: its Pallas ``flash_attention``
has no VJP, and JAX differentiates the model's attention through XLA. The
port's forward is the hand kernel (``FlashAttentionFn`` in ``ops.py``);
this function is its backward. It recomputes the probabilities P in
float32 from the saved q and k with the forward's mask (causal, sliding
window, GQA), and forms

    dV = P^T dO                     summed over the G query heads of a KV head
    dP = dO V^T
    dS = P o (dP - rowsum(dO o O))  (o: elementwise)
    dQ = scale dS K,  dK = scale dS^T Q (summed over G)

It holds the (B, K, G, S, S) f32 score tensor: a hand Hopper backward that
works from a saved log-sum-exp without it is still to do.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_bwd(q, k, v, o, do, *, causal: bool, window: int,
                        scale: float):
    """q, o, do (B,H,S,d); k, v (B,K,S,d) with H = K*G. Returns (dq, dk,
    dv) in the dtypes of q, k and v."""
    B, H, S, d = q.shape
    K = k.shape[1]
    G = H // K
    qf = q.reshape(B, K, G, S, d).float()
    kf, vf = k.float(), v.float()
    dof = do.reshape(B, K, G, S, d).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qf, kf) * scale
    i = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > (i[:, None] - window)
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, NEG_INF)),
                      dim=-1)
    del s
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dof)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, vf)
    delta = (dof * o.reshape(B, K, G, S, d).float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    del p, dp
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf) * scale
    return (dq.reshape(B, H, S, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
