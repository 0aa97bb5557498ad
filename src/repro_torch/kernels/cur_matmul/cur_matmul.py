"""ctypes wrapper of the CUDA kernel ``csrc/cur_matmul.cu``: y = (x @ CU) @ R.

``launches`` counts the kernel's launches in this process; it is bumped
where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_RANK = 512          # the (BM, r) intermediate must fit in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib():
    lib = _build.load("cur_matmul")
    fn = lib.cur_matmul_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def cur_matmul(x: torch.Tensor, cu: torch.Tensor, r: torch.Tensor
               ) -> torch.Tensor:
    """x (M, m) @ cu (m, rk) @ r (rk, n) -> (M, n) on a CUDA device.
    All three are contiguous, on one device, float32 or bfloat16 alike."""
    global launches
    for name, t in (("x", x), ("cu", cu), ("r", r)):
        if not t.is_cuda:
            raise ValueError(f"cur_matmul: {name} is not a CUDA tensor")
        if t.device != x.device:
            raise ValueError("cur_matmul: tensors on different devices")
        if t.dtype != x.dtype:
            raise ValueError(f"cur_matmul: {name} is {t.dtype}, x {x.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"cur_matmul: {name} must be 2-D contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"cur_matmul: dtype {x.dtype} not supported")
    M, m = x.shape
    rk, n = r.shape
    if cu.shape != (m, rk):
        raise ValueError(f"cur_matmul: shapes {tuple(x.shape)} "
                         f"{tuple(cu.shape)} {tuple(r.shape)} do not chain")
    if not 1 <= rk <= MAX_RANK:
        raise ValueError(f"cur_matmul: rank {rk} outside [1, {MAX_RANK}]")
    y = torch.empty((M, n), dtype=x.dtype, device=x.device)
    if M == 0 or n == 0:
        return y
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), cu.data_ptr(), r.data_ptr(), y.data_ptr(),
                 M, m, rk, n, _DTYPES[x.dtype], stream)
    _build.check(err, "cur_matmul launch")
    launches += 1
    return y
