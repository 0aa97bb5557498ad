"""Plain PyTorch version of the paged-attention decode kernel, plus the
rank-space CUR-KV query fold.

``paged_attention_ref`` is also the serving runtime's path for CPU
tensors: it gathers the paged pool through the block table and computes
attention in rank space. Masking matches the kernel, including zero
output for slots with no live position.
"""
import torch

NEG_INF = -1e30


def fold_q(q: torch.Tensor, uk, scale: float) -> torch.Tensor:
    """Fold the key link matrix and softmax scale into the query.

    q (..., hd); uk (r, hd) or None (dense pool). Returns (..., r) with
    ``q~ = scale * q @ Uk^T``, so ``q~ . k_r == scale * q . (k_r @ Uk)``."""
    qf = q.float() * scale
    if uk is not None:
        qf = qf @ uk.float().T
    return qf.to(q.dtype)


def unfold_o(o: torch.Tensor, uv) -> torch.Tensor:
    """(..., r) rank-space attention output -> (..., hd) through the value
    link matrix (identity when ``uv`` is None)."""
    if uv is None:
        return o
    return (o.float() @ uv.float()).to(o.dtype)


def paged_attention_ref(q, k_pool, v_pool, table, ctx_len, *,
                        window: int = 0, q_span: int = 1):
    """Gather-based oracle. q (B, K, G', r) folded/pre-scaled; pools
    (n_blocks, bs, K, r); table (B, maxb); ctx_len (B,). -> (B, K, G', r).

    ``q_span = S > 1`` is the speculative-verify layout: ``G' = S * G``
    rows per kv-head, row ``g`` at query position ``ctx + g // G``."""
    B, maxb = table.shape
    bs = k_pool.shape[1]
    L = maxb * bs
    Gq = q.shape[2]
    if q_span > 1 and Gq % q_span != 0:
        raise ValueError(f"q_span {q_span} must divide query rows {Gq}")
    tbl = table.long()
    ctx = ctx_len.long()
    ck = k_pool[tbl.clamp(min=0)].reshape(B, L, *k_pool.shape[2:])
    cv = v_pool[tbl.clamp(min=0)].reshape(B, L, *v_pool.shape[2:])
    s = torch.einsum("bkgr,btkr->bkgt", q.float(), ck.float())
    idx = torch.arange(L, device=q.device)
    blk = tbl.repeat_interleave(bs, dim=1)                 # (B, L)
    off = torch.arange(Gq, device=q.device) // (Gq // q_span)
    qpos = ctx[:, None] + off[None, :]                     # (B, G')
    valid = ((idx[None, None, :] <= qpos[:, :, None])
             & (blk >= 0)[:, None, :])                     # (B, G', L)
    if window > 0:
        valid &= idx[None, None, :] > (qpos[:, :, None] - window)
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # a row with no live position softmaxes to uniform garbage: zero it,
    # as the kernel's empty accumulator does
    p = p * valid.any(dim=-1)[:, None, :, None]
    o = torch.einsum("bkgt,btkr->bkgr", p, cv.float())
    return o.to(q.dtype)
