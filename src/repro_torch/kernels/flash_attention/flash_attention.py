"""ctypes wrapper of the CUDA kernel ``csrc/flash_attention.cu``.

Three bodies, one warp per 16 query rows and the online softmax in
registers in both bf16 ones: ``wg`` (bf16, d 64 or 128: both products on
wgmma, K/V tiles by TMA), ``mma`` (other bf16, d 16, 32 and 256 among
them: mma.sync, a two-stage cp.async K/V ring) and ``fma`` (f32). ``plan`` gives the body and the
launch geometry as a plain function of the shape, and ``kv_tiles`` the KV
tiles a block of query rows visits; both mirror the source.

``launches`` counts the kernel's launches in this process; it is bumped
where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_BODIES = {"fma": 0, "mma": 1, "wg": 2}

BQ = BKV = 64       # query rows per block, keys per KV tile
THREADS = 128       # 4 warps: in the bf16 bodies, 16 query rows each
WG_BOX = 64 * 64 * 2                # the wg body's TMA box, bytes

launches = 0


@dataclass(frozen=True)
class Plan:
    """How one call runs: the body, its grid (q tiles, heads, batch),
    threads per block and dynamic shared memory in bytes."""
    body: str
    grid: Tuple[int, int, int]
    threads: int
    smem_bytes: int


def plan(B: int, H: int, S: int, d: int, dtype: torch.dtype, *,
         aligned: bool = True) -> Plan:
    """``aligned``: q, k and v start on 16 bytes (TMA's condition)."""
    grid = (-(-S // BQ), H, B)
    if dtype == torch.bfloat16 and d in (64, 128) and aligned:
        # 1 KB alignment, the q tile and two (K, V) stages of d / 64 boxes,
        # three mbarriers
        return Plan("wg", grid, THREADS, 1024 + 5 * (d // 64) * WG_BOX + 24)
    if dtype == torch.bfloat16:      # q tile + two (K, V) stages, rows d + 8
        return Plan("mma", grid, THREADS, 2 * 5 * BQ * (d + 8))
    return Plan("fma", grid, THREADS,
                4 * ((BQ + 2 * BKV) * (d + 1) + BQ * (BKV + 1) + 3 * BQ))


def kv_tiles(q0: int, S: int, causal: bool, window: int) -> range:
    """The KV tiles the block of query rows q0 .. q0 + BQ - 1 visits: up to
    the causal edge, without the leading tiles wholly outside the window."""
    nk = -(-S // BKV)
    j_hi = min(nk - 1, (q0 + BQ - 1) // BKV) if causal else nk - 1
    j_lo = 0
    if window > 0:
        while j_lo <= j_hi and j_lo * BKV + BKV - 1 <= q0 - window:
            j_lo += 1
    return range(j_lo, j_hi + 1)


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,S,d); k,v (B,K,S,d), H = K*G -> (B,H,S,d) on a CUDA device.
    Contiguous, one device, float32 or bfloat16 alike, d in HEAD_DIMS."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is not a CUDA tensor")
        if t.device != q.device:
            raise ValueError("flash_attention: tensors on different devices")
        if t.dtype != q.dtype:
            raise ValueError(
                f"flash_attention: {name} is {t.dtype}, q {q.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be 4-D "
                             f"contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    B, H, S, d = q.shape
    K = k.shape[1]
    if H % K != 0:
        raise ValueError(
            f"GQA requires n_heads % n_kv_heads == 0; got H={H}, K={K}")
    if k.shape != (B, K, S, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if scale is None:
        scale = d ** -0.5
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B * H * S == 0:
        return o
    p = plan(B, H, S, d, q.dtype, aligned=q.dtype != torch.bfloat16 or all(
        t.data_ptr() % 16 == 0 for t in (q, k, v)))
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = _build.raw_stream(q.device.index)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, K, S, d, float(scale), int(causal), int(window),
                 _BODIES[p.body], stream)
    _build.check(err, f"flash_attention launch ({p.body})")
    launches += 1
    return o
