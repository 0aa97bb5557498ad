"""ctypes wrapper of the CUDA kernel ``csrc/flash_attention.cu``.

``launches`` counts the kernel's launches in this process; it is bumped
where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


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
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, K, S, d, float(scale), int(causal), int(window),
                 _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention launch")
    launches += 1
    return o
