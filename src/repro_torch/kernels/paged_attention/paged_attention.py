"""ctypes wrapper of the CUDA kernel ``csrc/paged_attention.cu``.

``launches`` counts the kernel's launches in this process; it is bumped
where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_RANK = 256          # feature dim r of the pools
MAX_ROWS = 64           # query rows G' per (slot, kv-head)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib():
    fn = _build.load("paged_attention").paged_attention_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_long] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_shapes(q, k_pool, v_pool, table, ctx_len, q_span: int) -> None:
    """The shape contract of the kernel and of its plain version."""
    B, K, G, r = q.shape
    if (tuple(k_pool.shape[2:]) != (K, r)
            or tuple(v_pool.shape) != tuple(k_pool.shape)):
        raise ValueError(
            f"pool/query mismatch: q {tuple(q.shape)}, k_pool "
            f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    if q_span < 1 or G % q_span != 0:
        raise ValueError(f"q_span {q_span} must divide query rows {G}")
    if table.dim() != 2 or table.shape[0] != B or tuple(ctx_len.shape) != (B,):
        raise ValueError(f"table {tuple(table.shape)} / ctx_len "
                         f"{tuple(ctx_len.shape)} do not match batch {B}")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table: torch.Tensor,
                    ctx_len: torch.Tensor, *, window: int = 0,
                    q_span: int = 1) -> torch.Tensor:
    """q (B, K, G', r) folded/pre-scaled; pools (n_blocks, bs, K, r);
    table (B, maxb) and ctx_len (B,) integer -> (B, K, G', r), on one CUDA
    device. q and the pools are float32 or bfloat16 alike; the pools'
    last dim is contiguous (any block, row and head strides)."""
    global launches
    check_shapes(q, k_pool, v_pool, table, ctx_len, q_span)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("ctx_len", ctx_len)):
        if not t.is_cuda:
            raise ValueError(f"paged_attention: {name} is not a CUDA tensor")
        if t.device != q.device:
            raise ValueError("paged_attention: tensors on different devices")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise ValueError(
                f"paged_attention: {name} is {t.dtype}, q {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"paged_attention: {name}'s last dim must be "
                             f"contiguous")
    if k_pool.stride() != v_pool.stride():
        raise ValueError("paged_attention: k_pool and v_pool strides differ")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention: dtype {q.dtype} not supported")
    B, K, G, r = q.shape
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"paged_attention: rank {r} outside [1, {MAX_RANK}]")
    if not 1 <= G <= MAX_ROWS:
        raise ValueError(
            f"paged_attention: {G} query rows outside [1, {MAX_ROWS}]")
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    ctx_len = ctx_len.to(torch.int32).contiguous()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B * K == 0:
        return o
    bs, maxb = k_pool.shape[1], table.shape[1]
    s_blk, s_row, s_head = k_pool.stride()[:3]
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 table.data_ptr(), ctx_len.data_ptr(), o.data_ptr(),
                 B, K, G, r, bs, maxb, s_blk, s_row, s_head, int(window),
                 int(q_span), _DTYPES[q.dtype], stream)
    _build.check(err, "paged_attention launch")
    launches += 1
    return o
