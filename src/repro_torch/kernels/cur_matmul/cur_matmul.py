"""ctypes wrapper of the CUDA kernels ``csrc/cur_matmul.cu``: y = (x @ CU) @ R.

Two bodies. bf16 shapes that TMA can describe (m, r and n multiples of 8,
16-byte-aligned bases) run the two-pass ``tc`` body: pass 1 ``x @ CU``
split over m into f32 partial sums, a fixed-order reduction that rounds
t once to bf16, pass 2 ``t @ R`` (both GEMMs TMA + wgmma). Every other
shape, and f32, runs the one-pass ``fused`` body. ``plan`` makes that
choice and the launch geometry as a plain function of the shape.

``launches`` counts calls that launched a body in this process (one per
call, whichever body ran); it is bumped where the kernels are launched and
nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.kernels import _build

MAX_RANK = 512          # the fused body's (BM, r) intermediate in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

FUSED_BM = 16                       # rows of x per block of the fused body
TC_BM, TC_BN, TC_BK = 128, 128, 64  # the tc body's output tile and slice
MAX_SPLITS = 16                     # cap on pass 1's splits of m
SMS = 132                           # H100 SXM; the wrapper asks the device

launches = 0


@dataclass(frozen=True)
class Plan:
    """How one call runs. ``grid``: (blocks,) for ``fused``; (pass 1,
    pass 2, reduction) blocks for ``tc``. ``workspace_bytes``: the f32
    partial sums and the bf16 t that the wrapper allocates (tc only)."""
    body: str
    grid: Tuple[int, ...]
    splits: int
    workspace_bytes: int


def tc_shape_ok(m: int, rk: int, n: int) -> bool:
    """TMA needs every row stride to be a multiple of 16 bytes."""
    return m % 8 == 0 and rk % 8 == 0 and n % 8 == 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan(M: int, m: int, rk: int, n: int, dtype: torch.dtype, *,
         sms: int = SMS, aligned: bool = True) -> Plan:
    """The launch plan of ``cur_matmul`` for x (M, m), CU (m, rk),
    R (rk, n) of ``dtype``; ``aligned``: every base is 16-byte aligned."""
    if dtype != torch.bfloat16 or not (aligned and tc_shape_ok(m, rk, n)):
        return Plan("fused", (_cdiv(M, FUSED_BM),), 1, 0)
    tiles_m = _cdiv(M, TC_BM)
    base = tiles_m * _cdiv(rk, TC_BN)
    splits = max(1, min(_cdiv(m, TC_BK), MAX_SPLITS, sms // base))
    grid1 = min(base * splits, sms)
    grid2 = tiles_m * max(1, min(_cdiv(n, TC_BN), sms // tiles_m))
    grid_r = max(1, min(_cdiv(M * rk // 4, 256), 8 * sms))
    return Plan("tc", (grid1, grid2, grid_r), splits,
                4 * splits * M * rk + 2 * M * rk)


def work_items(M: int, N: int, K: int, splits: int
               ) -> List[Tuple[int, int, int, int, int]]:
    """Every work item of pass 1 (C = A (M, K) @ B (K, N), split-K) as
    (row tile, column tile, split, first slice, end slice), in the order
    of ``pass1_kernel``'s ``decode``; block b takes items b, b + grid, ..."""
    tiles_m, tiles_n, kt = _cdiv(M, TC_BM), _cdiv(N, TC_BN), _cdiv(K, TC_BK)
    out = []
    for it in range(tiles_m * tiles_n * splits):
        mt, rest = it % tiles_m, it // tiles_m
        nt, s = rest % tiles_n, rest // tiles_n
        out.append((mt, nt, s, s * kt // splits, (s + 1) * kt // splits))
    return out


def pass2_tiles(M: int, n: int, block: int, grid: int
                ) -> List[Tuple[int, int]]:
    """The (row tile, column tile) outputs of pass 2's block ``block`` of
    ``grid``, in ``pass2_kernel``'s order: its row tile is
    block % tiles_m, its column tiles a stride of grid / tiles_m."""
    tiles_m = _cdiv(M, TC_BM)
    per_m = grid // tiles_m
    return [(block % tiles_m, nt) for nt in
            range(block // tiles_m, _cdiv(n, TC_BN), per_m)]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _fn(name: str, nargs_ptr: int, nargs_int: int):
    fn = getattr(_build.load("cur_matmul"), name)
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * nargs_ptr
                       + [ctypes.c_int] * nargs_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return (_fn("cur_matmul_launch", 4, 5),
            _fn("cur_matmul_tc_launch", 6, 8))


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
    if x.dtype == torch.bfloat16:
        p = plan(M, m, rk, n, x.dtype, sms=_sm_count(x.device.index),
                 aligned=all(t.data_ptr() % 16 == 0 for t in (x, cu, r)))
    else:
        p = plan(M, m, rk, n, x.dtype)
    fused, tc = _lib()
    with torch.cuda.device(x.device):
        stream = _build.raw_stream(x.device.index)
        if p.body == "tc":   # the f32 partial sums, then t (bf16)
            ws = torch.empty(p.workspace_bytes, dtype=torch.uint8,
                             device=x.device)
            w = ws.data_ptr()
            err = tc(x.data_ptr(), cu.data_ptr(), r.data_ptr(), y.data_ptr(),
                     w, w + 4 * p.splits * M * rk, M, m, rk, n, p.splits,
                     *p.grid, stream)
        else:
            err = fused(x.data_ptr(), cu.data_ptr(), r.data_ptr(),
                        y.data_ptr(), M, m, rk, n, _DTYPES[x.dtype], stream)
    _build.check(err, f"cur_matmul launch ({p.body})")
    launches += 1
    return y
