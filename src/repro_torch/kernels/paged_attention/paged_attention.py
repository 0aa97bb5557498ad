"""ctypes wrapper of the CUDA kernel ``csrc/paged_attention.cu``.

Split-KV decode attention: grid (B K, splits), each block a contiguous run
of table entries of one (slot, kv-head), its live entries' K and V through
a three-stage cp.async ring, and the splits merged in a fixed order by the
last block of each (slot, kv-head). Two bodies, chosen by dtype: ``mma``
(bf16: mma.sync scores and PV, softmax in registers) and ``fma`` (f32,
exact on FMA units). ``plan`` gives the body, the padded rank, the split
of the table, shared memory and workspace as a plain function of the
shape; the source checks the values it is given.

``launches`` counts calls that launched the kernel in this process (one
per call); it is bumped where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

MAX_RANK = 256          # feature dim r of the pools
MAX_ROWS = 64           # query rows G' per (slot, kv-head)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BODIES = {torch.float32: "fma", torch.bfloat16: "mma"}

RANKS = (16, 32, 64, 128, 256)   # widths r is zero-padded to
THREADS = 128                    # 4 warps
STAGES = 3                       # depth of the K/V ring
MIN_SPLIT_TOKENS = 64            # a split covers at least this many tokens
MAX_ENTRIES = 512                # table entries per split (the live list)
MAX_SPLITS = 64
MAX_BLOCKS_PER_SM = 4            # registers allow no more at r >= 64
SMS = 132                        # H100 SXM; the wrapper asks the device
SMEM_PER_SM = 233_472            # shared memory of an H100 SM, bytes
SMEM_PER_BLOCK = 1_024           # what the card reserves per block

launches = 0

# per (device, stream): the scratch of split calls, [counters | workspace],
# and the bytes of its counters. The counters (one int32 per (slot,
# kv-head)) are how the last block of a (slot, kv-head) finds itself; they
# are zero between calls (the kernel resets them), so the buffer is made
# zeroed and reused in stream order, and made anew when a call needs more
# counters; the f32 workspace behind them needs no initial value.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}


@dataclass(frozen=True)
class Plan:
    """How one call runs. ``rank``: r zero-padded to one of ``RANKS``;
    ``stage_tokens``: tokens per ring stage; ``splits`` runs of
    ``entries_per_split`` table entries; ``grid`` (B K, splits);
    ``workspace_bytes``: the f32 acc, m and l of every split (0 when
    ``splits`` is 1: the blocks write the output)."""
    body: str
    rank: int
    stage_tokens: int
    splits: int
    entries_per_split: int
    grid: Tuple[int, int]
    threads: int
    smem_bytes: int
    workspace_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan(B: int, K: int, G: int, r: int, bs: int, maxb: int,
         dtype: torch.dtype, *, sms: int = SMS) -> Plan:
    """The launch plan for q (B, K, G, r) of ``dtype``, pools of block size
    ``bs`` and a table of ``maxb`` entries per slot on a card of ``sms``
    SMs. It depends on shapes only (the contexts live on the device).

    ``splits`` fills the card once: B K splits is about the blocks that
    are resident at a time (``blocks_per_sm(...)`` sms; one wave, so no
    block waits for another's tail), while every split covers at least
    ``MIN_SPLIT_TOKENS`` tokens; one split for small tables and full
    grids. Shared memory mirrors ``smem_bytes`` in the source: the ring
    (rows padded 16 bytes), the f32 body's q rows, each stage's token
    positions, the live list, per-row M and L and two ints."""
    if dtype not in _DTYPES:
        raise ValueError(f"paged_attention: dtype {dtype} not supported")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"paged_attention: rank {r} outside [1, {MAX_RANK}]")
    if not 1 <= G <= MAX_ROWS:
        raise ValueError(
            f"paged_attention: {G} query rows outside [1, {MAX_ROWS}]")
    if _cdiv(maxb, MAX_ENTRIES) > MAX_SPLITS:
        raise ValueError(f"paged_attention: a table of {maxb} entries is "
                         f"longer than {MAX_SPLITS * MAX_ENTRIES}")
    es = 4 if dtype == torch.float32 else 2
    rank = next(w for w in RANKS if w >= r)
    ts = min(64, 16384 // (rank * es))
    ring = STAGES * 2 * ts * (rank + 16 // es) * es
    q_rows = _cdiv(G, 16) * 16 * (rank + 4) * 4 if es == 4 else 0
    fixed = ring + q_rows + STAGES * ts * 4 + 2 * MAX_ROWS * 4 + 16
    want = max(1, blocks_per_sm(fixed) * sms // max(1, B * K))
    splits = min(want, maxb // _cdiv(MIN_SPLIT_TOKENS, bs), MAX_SPLITS)
    splits = max(splits, 1, _cdiv(maxb, MAX_ENTRIES))
    eps = max(1, _cdiv(maxb, splits))
    splits = max(1, _cdiv(maxb, eps))
    smem = fixed + _cdiv(12 * eps, 16) * 16
    ws = 4 * B * K * splits * G * (r + 2) if splits > 1 else 0
    return Plan(_BODIES[dtype], rank, ts, splits, eps, (B * K, splits),
                THREADS, smem, ws)


def blocks_per_sm(smem_bytes: int) -> int:
    """Blocks an SM holds at once by shared memory (with 1 KB left for a
    split's live list), at most ``MAX_BLOCKS_PER_SM``."""
    per_block = smem_bytes + 1_024 + SMEM_PER_BLOCK
    return max(1, min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // per_block))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _scratch(device: torch.device, stream: int, counters: int,
             ws_bytes: int) -> Tuple[int, int]:
    """Device addresses of ``counters`` zero int32 and ``ws_bytes`` of
    16-byte-aligned workspace, from the (device, stream)'s buffer."""
    key = (device.index, stream)
    buf, head = _SCRATCH.get(key, (None, 0))
    need = -(-4 * counters // 256) * 256
    if buf is None or need > head or buf.numel() < head + ws_bytes:
        head = max(head, need)
        old = 0 if buf is None else buf.numel()
        buf = torch.zeros(max(head + ws_bytes, 2 * old), dtype=torch.uint8,
                          device=device)
        _SCRATCH[key] = (buf, head)
    base = buf.data_ptr()
    return base, base + head


# the source's `Launch`: nine pointers and three strides (int64), then
# fourteen int32
_LAUNCH = struct.Struct("<12q14i")


def _lib():
    fn = _build.load("paged_attention").paged_attention_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_char_p]
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
    if not q.is_contiguous():
        q = q.contiguous()
    if table.dtype != torch.int32 or not table.is_contiguous():
        table = table.to(torch.int32).contiguous()
    if ctx_len.dtype != torch.int32 or not ctx_len.is_contiguous():
        ctx_len = ctx_len.to(torch.int32).contiguous()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B * K == 0:
        return o
    bs, maxb = k_pool.shape[1], table.shape[1]
    s_blk, s_row, s_head = k_pool.stride()[:3]
    dev = q.device.index
    p = plan(B, K, G, r, bs, maxb, q.dtype, sms=_sm_count(dev))
    fn = _lib()
    stream = _build.raw_stream(dev)
    cnt = ws = 0
    if p.splits > 1:
        cnt, ws = _scratch(q.device, stream, B * K, p.workspace_bytes)
    packed = _LAUNCH.pack(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        ctx_len.data_ptr(), o.data_ptr(), ws, cnt, stream, s_blk, s_row,
        s_head, B, K, G, r, bs, maxb, int(window), int(q_span),
        _DTYPES[q.dtype], p.rank, p.splits, p.entries_per_split,
        p.smem_bytes, 0)
    if dev == torch.cuda.current_device():
        err = fn(packed)
    else:
        with torch.cuda.device(dev):
            err = fn(packed)
    _build.check(err, f"paged_attention launch ({p.body})")
    launches += 1
    return o
