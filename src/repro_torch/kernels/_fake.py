"""Shape-only runs of the three kernel ops on fake tensors.

A dry run (``repro_torch.launch.dryrun``) traces the placed steps on
``FakeTensor``s of device "cuda": shapes and dtypes with no memory and no
card. Each op's wrapper (``kernels/*/ops.py``) sends fake inputs here and
nothing else: the function returns an empty (fake) output of the kernel's
shape, launches nothing (the wrappers' ``launches`` counts stay as they
are) and, while :func:`recording`, notes the kernel's FLOPs and HBM bytes
from the shapes, by the bound formulas of the kernel table in
``chip_smoke.py``: each input read once and each output written once, two
FLOPs a multiply-add. Where a real kernel's work depends on the data (the
paged kernel stops at each slot's context) the count is the table's whole
window, every entry live. A real tensor, on the CPU or the card, raises
here.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

_RECORD: Optional[List[Tuple[str, int, int]]] = None


def _fake_type():
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor


def is_fake(*ts) -> bool:
    """Whether any of ``ts`` is a fake tensor (the shape-only path)."""
    fake = _fake_type()
    return any(isinstance(t, fake) for t in ts)


def _check(name: str, ts) -> None:
    fake = _fake_type()
    real = [i for i, t in enumerate(ts) if not isinstance(t, fake)]
    if real:
        raise TypeError(f"{name}: the shape-only path takes fake tensors "
                        f"only (inputs {real} are real)")


@contextlib.contextmanager
def recording():
    """Notes (kernel, FLOPs, bytes) of each shape-only call inside the
    block into the yielded list."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _note(name: str, flops: int, nbytes: int) -> None:
    if _RECORD is not None:
        _RECORD.append((name, int(flops), int(nbytes)))


def live_pairs(S: int, window: int) -> int:
    """Causal (query, key) pairs inside ``window`` (0: none) over S
    positions."""
    if not window or S <= window:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def cur_matmul(x: torch.Tensor, cu: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """x (M, m) @ cu (m, rk) @ r (rk, n) -> an empty (M, n)."""
    _check("cur_matmul", (x, cu, r))
    M, m = x.shape
    rk, n = r.shape
    es = x.element_size()
    _note("cur_matmul", 2 * M * rk * (m + n),
          es * (M * m + m * rk + rk * n + M * n))
    return x.new_empty((M, n))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int) -> torch.Tensor:
    """q (B, H, S, d), k / v (B, K, S, d), causal -> an empty (B, H, S,
    d)."""
    _check("flash_attention", (q, k, v))
    B, H, S, d = q.shape
    K = k.shape[1]
    es = q.element_size()
    _note("flash_attention", 4 * B * H * d * live_pairs(S, window),
          es * (2 * B * H * S * d + 2 * B * K * S * d))
    return q.new_empty(q.shape)


def paged_attention(q, k_pool, v_pool, table, ctx_len,
                    window: int) -> torch.Tensor:
    """q (B, K, G', r) against pools (nb, bs, K, r) through ``table`` (B,
    maxb) -> an empty (B, K, G', r); every table entry counted live."""
    _check("paged_attention", (q, k_pool, v_pool, table, ctx_len))
    B, K, G, r = q.shape
    span = table.shape[1] * k_pool.shape[1]
    live = B * K * (min(span, window) if window else span)
    es = q.element_size()
    _note("paged_attention", 4 * live * G * r,
          es * (2 * live * r + 2 * B * K * G * r))
    return q.new_empty(q.shape)
