"""Plain PyTorch version of the flash attention kernel (GQA, causal,
optional sliding window, explicit scale)."""
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None):
    """q (B,H,S,d); k,v (B,K,S,d) with H = K*G. Returns (B,H,S,d).
    ``scale=None`` uses 1/sqrt(d)."""
    B, H, S, d = q.shape
    K = k.shape[1]
    if H % K != 0:
        raise ValueError(
            f"GQA requires n_heads % n_kv_heads == 0; got H={H}, K={K}")
    G = H // K
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(B, K, G, S, d)
    s = torch.einsum("bkgsd,bktd->bkgst", qg.float(), k.float()) * scale
    i = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > (i[:, None] - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, S, d).to(q.dtype)
