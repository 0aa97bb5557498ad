"""Plain PyTorch attention used by the registry's ``mix`` variant.

The file keeps the JAX package's name (``repro/attention/xla.py``) so a
reader finds the counterpart; nothing here is XLA. The three functions are
the dense masked softmax (the oracle and small-S path), the chunked online
softmax (full causal) and the banded sliding-window path. All three work at
any feature dim.

Layout contract (the ``mix`` variant):
  q  (B, Sq, K, G, d)  GQA-grouped queries
  k,v (B, Skv, K, d)
  q_pos / kv_pos (B, Sq) / (B, Skv) absolute positions (causal masking is
  positional).
"""
from __future__ import annotations

import torch

DENSE_MAX = 2048     # use dense masked softmax at or below this seq len
CHUNK = 512          # flash chunk (query and kv)

NEG_INF = -1e30


def _scores(q, k, scale):
    """(B,Sq,K,G,d) x (B,Skv,K,d) -> (B,K,G,Sq,Skv) f32 scaled scores."""
    return torch.einsum("bqkgd,btkd->bkgqt", q, k).float() * scale


def dense_attn(q, k, v, q_pos, kv_pos, window: int, scale: float):
    """q (B,Sq,K,G,d); k,v (B,Skv,K,d); positions (B,Sq)/(B,Skv)."""
    s = _scores(q, k, scale)
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]            # causal
    if window > 0:
        mask &= kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)


def _flash_chunk_update(carry, s, v_chunk):
    """Online softmax update. carry: (m, l, acc); s: (B,K,G,cq,ck) f32."""
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bkgqt,btkd->bkgqd", p.to(v_chunk.dtype), v_chunk).float()
    return m_new, l_new, acc_new


def flash_attn(q, k, v, q_pos, kv_pos, scale: float, chunk: int):
    """Nested-chunk online softmax (full causal). q (B,Sq,K,G,d),
    k/v (B,Skv,K,d). Sq and Skv must be multiples of their chunk."""
    B, Sq, K, G, hd = q.shape
    Skv = k.shape[1]
    cq, ck = min(chunk, Sq), min(chunk, Skv)
    nq, nk = Sq // cq, Skv // ck
    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq]
        qpi = q_pos[:, i * cq:(i + 1) * cq]
        carry = (torch.full((B, K, G, cq), NEG_INF, device=q.device),
                 torch.zeros((B, K, G, cq), device=q.device),
                 torch.zeros((B, K, G, cq, hd), device=q.device))
        for j in range(nk):
            kj = k[:, j * ck:(j + 1) * ck]
            vj = v[:, j * ck:(j + 1) * ck]
            kpj = kv_pos[:, j * ck:(j + 1) * ck]
            s = _scores(qi, kj, scale)
            mask = kpj[:, None, :] <= qpi[:, :, None]
            s = torch.where(mask[:, None, None], s,
                            torch.full_like(s, NEG_INF))
            carry = _flash_chunk_update(carry, s, vj)
        m, l, acc = carry
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4))           # (B,cq,K,G,hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def banded_attn(q, k, v, q_pos, kv_pos, window: int, scale: float,
                chunk: int):
    """Sliding-window attention: query chunk i attends to the KV slice
    [i*cq - band, i*cq + cq), band = ceil(window/cq)*cq."""
    B, Sq, K, G, hd = q.shape
    cq = min(chunk, Sq)
    nq = Sq // cq
    band = -(-window // cq) * cq
    width = band + cq
    kpad = torch.nn.functional.pad(k, (0, 0, 0, 0, band, 0))
    vpad = torch.nn.functional.pad(v, (0, 0, 0, 0, band, 0))
    ppad = torch.nn.functional.pad(kv_pos, (band, 0), value=-(10 ** 9))
    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq]
        qpi = q_pos[:, i * cq:(i + 1) * cq]
        start = i * cq
        ks = kpad[:, start:start + width]
        vs = vpad[:, start:start + width]
        ps = ppad[:, start:start + width]
        s = _scores(qi, ks, scale)
        mask = (ps[:, None, :] <= qpi[:, :, None]) & (
            ps[:, None, :] > qpi[:, :, None] - window)
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqt,btkd->bqkgd", p.to(vs.dtype), vs))
    return torch.cat(outs, dim=1).to(q.dtype)
