"""Block-table paged KV cache with an optional CUR-compressed KV mode.

The pool holds ``n_blocks`` fixed-size blocks per layer, shared by every
live sequence; a sequence owns an ordered list of block ids (its block
table row) and token ``t`` lives at ``(table[t // bs], t % bs)``. The
host-side :class:`BlockAllocator` manages the free list with refcounts so
tables can be forked (shared-prefix / beam reuse) copy-on-write style.

CUR-KV mode stores only ``r`` of the ``head_dim`` feature columns of each
roped key/value -- column indices are DEIM-selected from the right singular
vectors of a calibration K/V matrix (the machinery ``core.cur`` uses for
weight CUR) -- plus a small ``(r, head_dim)`` link matrix
``U = pinv(K[:, q]) @ K`` so ``k_hat = k_store @ U``. With
``r == head_dim`` the selection is a permutation and the mode is exact.

Unlike the JAX package, whose pool updates are functional, the ``write_*``
and ``copy_cache_blocks`` functions here write the pool tensors in place
(and return them). A write keeps only its valid ``(block, offset)`` rows
-- those of an active slot, inside its length, with an assigned table
entry (>= 0) inside the table's width -- and drops the rest, as the JAX
package's ``n_blocks`` drop sentinel does. The valid rows are found on
the device of the table: a table on the CPU costs the device no
synchronisation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cur import exact_svd, pinv
from repro_torch.core.deim import deim
from repro_torch.dist.sharding import (
    Placed, local_shape, paged_cache_pspecs)
from repro_torch.models.model import torch_dtype


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Static layout of the paged pool (one pool per attention layer)."""
    block_size: int = 16
    n_blocks: int = 256            # pool blocks shared by all sequences
    max_blocks_per_seq: int = 8    # block-table width
    cur_kv: bool = False
    kv_rank: int = 0               # 0 -> head_dim (layout change only)

    @property
    def max_len(self) -> int:
        return self.block_size * self.max_blocks_per_seq

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def rank(self, head_dim: int) -> int:
        if not self.cur_kv or self.kv_rank <= 0:
            return head_dim
        return min(self.kv_rank, head_dim)

    @classmethod
    def sized_for(cls, max_len: int, concurrency: int,
                  block_size: int = 16, **kw) -> "PagedConfig":
        """Pool sized so ``concurrency`` sequences of up to ``max_len``
        tokens fit, with one spare block per sequence of headroom."""
        maxb = -(-max_len // block_size) + 1
        return cls(block_size=block_size, n_blocks=maxb * concurrency,
                   max_blocks_per_seq=maxb, **kw)


# ---------------------------------------------------------------------------
# host-side block allocator
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Free-list allocator with refcounts (fork = shared, copy-on-write).

    When an obs :class:`~repro_torch.obs.metrics.Registry` is attached, pool
    traffic becomes first-class signals: alloc/free/fork/CoW counters
    plus a live occupancy gauge (``repro_serving_pool_blocks_used``).
    Without one the hooks are the shared NULL instrument — zero cost.
    """

    def __init__(self, n_blocks: int, obs=None):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._squeezed: List[int] = []  # chaos-held blocks (see squeeze)
        self.blocks_freed_window = 0   # lifetime out-of-window frees
        if obs is None:
            from repro_torch.obs.metrics import NULL
            self._m_alloc = self._m_free = self._m_fork = NULL
            self._m_cow = self._m_used = self._m_window = NULL
        else:
            self._m_alloc = obs.counter(
                "repro_serving_pool_alloc_total",
                "blocks handed out by the pool")
            self._m_free = obs.counter(
                "repro_serving_pool_free_total",
                "block references dropped")
            self._m_fork = obs.counter(
                "repro_serving_pool_fork_total",
                "blocks shared by table forks")
            self._m_cow = obs.counter(
                "repro_serving_pool_cow_total",
                "copy-on-write block copies")
            self._m_used = obs.gauge(
                "repro_serving_pool_blocks_used",
                "live (referenced) pool blocks")
            self._m_window = obs.counter(
                "repro_serving_pool_window_freed_total",
                "blocks freed for falling out of the sliding window")

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        """Live (referenced) pool blocks — the occupancy the
        ``repro_serving_pool_blocks_used`` gauge tracks."""
        return self.n_blocks - len(self._free)

    def assert_used(self, *, exactly: Optional[int] = None,
                    at_most: Optional[int] = None) -> int:
        """Occupancy invariant helper (tests / scheduler churn): checks
        the live-block count and returns it."""
        u = self.used
        if exactly is not None and u != exactly:
            raise AssertionError(
                f"pool_blocks_used: expected exactly {exactly}, got {u}")
        if at_most is not None and u > at_most:
            raise AssertionError(
                f"pool_blocks_used: expected <= {at_most}, got {u}")
        return u

    def ref(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks (refcount 1 each), or None if the pool is dry."""
        if n < 0 or n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self._m_alloc.inc(n)
        self._m_used.set(self.n_blocks - len(self._free))
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; zero-ref blocks rejoin the pool."""
        for b in blocks:
            r = self._ref.get(b)
            if r is None:
                raise ValueError(f"double free of block {b}")
            if r == 1:
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = r - 1
        self._m_free.inc(len(blocks))
        self._m_used.set(self.n_blocks - len(self._free))

    def fork(self, blocks: Sequence[int]) -> List[int]:
        """Share a block list (prefix reuse): bump refcounts, same ids."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"fork of unallocated block {b}")
            self._ref[b] += 1
        self._m_fork.inc(len(blocks))
        return list(blocks)

    def free_window(self, blocks: List[int], ctx_len: int, window: int,
                    block_size: int) -> int:
        """Free the blocks of ``blocks`` (one slot's table row, mutated in
        place) that have fallen wholly behind a sliding window of size
        ``window`` at context length ``ctx_len``.

        The decode mask ``idx > ctx - window`` only excludes more
        positions as ``ctx`` grows, so block ``bi`` (covering positions
        ``[bi*bs, (bi+1)*bs)``) is dead *forever* once
        ``(bi + 1) * bs <= ctx_len - window + 1``. Freed entries become
        ``-1`` holes — the list keeps its length so ``len(blocks) * bs``
        capacity math and ``t // bs`` table indexing stay valid, and the
        device block table passes the holes through (reads mask
        ``blk < 0``, writes drop). Returns the number freed and bumps
        ``blocks_freed_window`` / the obs counter."""
        if window <= 0:
            return 0
        dead_until = ctx_len - window + 1          # first live position
        freed = []
        for bi, b in enumerate(blocks):
            if (bi + 1) * block_size > dead_until:
                break                              # dead prefix is over
            if b >= 0:
                freed.append(b)
                blocks[bi] = -1
        if freed:
            self.free(freed)
            self.blocks_freed_window += len(freed)
            self._m_window.inc(len(freed))
        return len(freed)

    # -- chaos hook ----------------------------------------------------
    def squeeze(self, n: int) -> int:
        """Take up to ``n`` free blocks out of circulation (fault
        injection: a co-tenant eating pool capacity). Squeezed blocks
        are invisible to ``alloc`` until :meth:`release_squeeze`; they
        count as used so pressure signals see the squeeze. Returns the
        number actually taken."""
        take = self.alloc(min(n, len(self._free)))
        if not take:
            return 0
        self._squeezed.extend(take)
        return len(take)

    def release_squeeze(self) -> int:
        """Return every squeezed block to the pool."""
        held, self._squeezed = self._squeezed, []
        if held:
            self.free(held)
        return len(held)

    def copy_on_write(self, block: int) -> Optional[int]:
        """Before writing a shared block: returns a fresh private block to
        copy into (caller copies pool data), or ``block`` itself when it is
        already exclusive. None if no block is free for the copy."""
        if self._ref.get(block, 0) <= 1:
            return block
        fresh = self.alloc(1)
        if fresh is None:
            return None
        self._ref[block] -= 1
        self._m_cow.inc()
        return fresh[0]


# ---------------------------------------------------------------------------
# device-side pool
# ---------------------------------------------------------------------------

def _attn_layers(cfg: ModelConfig) -> int:
    """Number of attention layers (the paged runtime's supported mixers)."""
    return sum(1 for spec in cfg.blocks
               if spec.mixer in ("attn", "attn_local"))


def supports(cfg: ModelConfig) -> bool:
    """The paged runtime covers pure-attention stacks (mamba state is not
    paged)."""
    return all(s.mixer in ("attn", "attn_local") for s in cfg.blocks)


def serving_window(cfg: ModelConfig) -> int:
    """Pool-eviction window for a serving config: out-of-window blocks may
    be freed only when EVERY attention layer is sliding-window (one global
    layer pins the whole context, so mixed stacks return 0)."""
    if cfg.window > 0 and all(s.mixer == "attn_local" for s in cfg.blocks):
        return cfg.window
    return 0


def init_paged_cache(cfg: ModelConfig, pc: PagedConfig, device=None,
                     mesh=None, kernel: bool = True) -> dict:
    """Pool dict: k/v (L, n_blocks, block_size, K, r) plus, in CUR-KV mode,
    per-layer column indices and link matrices (identity-truncation
    placeholders until :func:`projections_from_kv` calibrates them).

    With a ``mesh`` (a ``DeviceMesh`` or a ``Placed``) k and v are this
    rank's shards per ``paged_cache_pspecs(kernel=kernel)``, made at their
    local shape: by default the kernel's layout (kv-heads over 'model',
    replicated where they do not divide), which the CUDA kernel and its
    plain version both grid over; ``kernel=False`` takes the einsum specs'
    rank / block-pool fallbacks, under which a step attends through the
    pool gathered over 'model'."""
    device = resolve_device(device)
    L = _attn_layers(cfg)
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    r = pc.rank(hd)
    shape = (L, pc.n_blocks, pc.block_size, K, r)
    if mesh is not None:
        m = mesh.mesh if isinstance(mesh, Placed) else mesh
        shape = local_shape(shape, pool_spec(cfg, pc, m, kernel), m)
    dtype = torch_dtype(cfg.dtype)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if pc.cur_kv:
        eye = torch.eye(r, hd, device=device).repeat(L, 1, 1)
        idx = torch.arange(r, device=device).repeat(L, 1)
        cache["proj"] = {"qk": idx, "uk": eye, "qv": idx.clone(),
                         "uv": eye.clone()}
    return cache


@functools.lru_cache(maxsize=32)
def pool_spec(cfg: ModelConfig, pc: PagedConfig, mesh, kernel: bool):
    """The spec of the k / v pools (L, n_blocks, bs, K, r) on ``mesh``
    per ``paged_cache_pspecs``."""
    shape = (_attn_layers(cfg), pc.n_blocks, pc.block_size, cfg.n_kv_heads,
             pc.rank(cfg.resolved_head_dim))
    meta = {"k": torch.empty(shape, device="meta")}
    return paged_cache_pspecs(meta, cfg, mesh, kernel=kernel)["k"]


def placed_pool_spec(cache: dict, cfg: ModelConfig, pc: PagedConfig, mesh):
    """The spec a pool of :func:`init_paged_cache` was placed by on
    ``mesh``: the kernel's layout or the einsum specs', whichever its
    local shape is. Raises for a pool placed by neither (a whole pool on
    a mesh that shards it: place it with ``init_paged_cache(mesh=)``)."""
    shape = (_attn_layers(cfg), pc.n_blocks, pc.block_size, cfg.n_kv_heads,
             pc.rank(cfg.resolved_head_dim))
    for kernel in (True, False):
        spec = pool_spec(cfg, pc, mesh, kernel)
        if tuple(cache["k"].shape) == local_shape(shape, spec, mesh):
            return spec
    raise ValueError(f"pool of shape {tuple(cache['k'].shape)} is not "
                     f"placed per paged_cache_pspecs on this mesh "
                     f"(init_paged_cache(mesh=))")


def cache_bytes(cache: dict) -> int:
    """Device bytes held by the k/v pools (excludes the tiny projections)."""
    return int(cache["k"].numel() * cache["k"].element_size()
               + cache["v"].numel() * cache["v"].element_size())


# ---------------------------------------------------------------------------
# CUR-KV projection (the core.cur selection machinery)
# ---------------------------------------------------------------------------

def kv_projection(mat: torch.Tensor, r: int):
    """mat (N, hd) stacked calibration rows -> (q (r,) int64, U (r, hd))
    with mat ~ mat[:, q] @ U. DEIM column selection on the leading right
    singular vectors; Frobenius-optimal link via pseudo-inverse."""
    mat = mat.float()
    hd = mat.shape[1]
    r = min(r, hd)
    _, _, Q = exact_svd(mat, r)          # Q: (hd, r) right singular vectors
    q = torch.sort(deim(Q[:, :r])).values
    U = pinv(mat[:, q]) @ mat
    return q, U


def projections_from_kv(ks, vs, r: int) -> dict:
    """Per-layer projections from collected calibration K/V.

    ks/vs: lists (one per attention layer) of (B, S, K, hd) tensors."""
    qks, uks, qvs, uvs = [], [], [], []
    for k, v in zip(ks, vs):
        hd = k.shape[-1]
        qk, uk = kv_projection(k.reshape(-1, hd), r)
        qv, uv = kv_projection(v.reshape(-1, hd), r)
        qks.append(qk)
        uks.append(uk)
        qvs.append(qv)
        uvs.append(uv)
    return {"qk": torch.stack(qks), "uk": torch.stack(uks),
            "qv": torch.stack(qvs), "uv": torch.stack(uvs)}


def compress_kv(x: torch.Tensor, q: Optional[torch.Tensor]) -> torch.Tensor:
    """(..., hd) -> (..., r): keep the DEIM-selected feature columns."""
    if q is None:
        return x
    return torch.index_select(x, -1, q.long())


def reconstruct_kv(x: torch.Tensor, U: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """(..., r) -> (..., hd): apply the link matrix."""
    if U is None:
        return x
    return (x.float() @ U).to(x.dtype)


# ---------------------------------------------------------------------------
# pool read / write (in place; invalid rows drop)
# ---------------------------------------------------------------------------

Rows = Tuple[torch.Tensor, ...]


@contextlib.contextmanager
def host_math():
    """Index math on host tensors (block tables, contexts) computes real
    values even while a fake-tensor mode traces the device work (the dry
    run, ``repro_torch.launch.dryrun``, whose host inputs are real): the
    mode is set aside for the block. Elsewhere a no-op."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        yield


def _lookup(table: torch.Tensor, bi: torch.Tensor):
    """table[b, bi] for bi (B, S) -> (blk, inside): entries past the
    table's width read -1 and ``inside`` is False there."""
    maxb = table.shape[1]
    inside = bi < maxb
    blk = torch.gather(table.long(), 1, bi.clamp(0, maxb - 1))
    return torch.where(inside, blk, torch.full_like(blk, -1)), inside


def prompt_rows(table: torch.Tensor, lengths: torch.Tensor, S: int,
                block_size: int) -> Rows:
    """Valid rows of a padded prompt write: (b, t, block, offset) index
    tensors for every token ``t < lengths[b]`` with an assigned block."""
    with host_math():
        return _prompt_rows(table, lengths, S, block_size)


def _prompt_rows(table, lengths, S, block_size):
    B = table.shape[0]
    t = torch.arange(S, device=table.device)
    blk, inside = _lookup(table, (t // block_size).expand(B, S))
    valid = (t[None] < lengths.to(table.device)[:, None]) & (blk >= 0) \
        & inside
    b_i, t_i = valid.nonzero(as_tuple=True)
    return b_i, t_i, blk[b_i, t_i], t_i % block_size


def span_rows(table: torch.Tensor, start: torch.Tensor,
              active: torch.Tensor, S: int, block_size: int) -> Rows:
    """Valid rows of an ``S``-position write per slot at positions
    ``start .. start + S - 1``: (b, s, block, offset)."""
    with host_math():
        return _span_rows(table, start, active, S, block_size)


def _span_rows(table, start, active, S, block_size):
    t = start.to(table.device).long()[:, None] + torch.arange(
        S, device=table.device)[None]
    blk, inside = _lookup(table, t // block_size)
    valid = active.to(table.device)[:, None] & (blk >= 0) & inside
    b_i, s_i = valid.nonzero(as_tuple=True)
    return b_i, s_i, blk[b_i, s_i], t[b_i, s_i] % block_size


def token_rows(table: torch.Tensor, pos: torch.Tensor,
               active: torch.Tensor, block_size: int) -> Rows:
    """Valid rows of a one-token-per-slot write at ``pos``: (b, block,
    offset)."""
    b_i, _, blk, off = span_rows(table, pos, active, 1, block_size)
    return b_i, blk, off


def rows_to(rows: Rows, device) -> Rows:
    """The row index tensors on ``device`` (a no-op where they are)."""
    return tuple(t.to(device, non_blocking=True) for t in rows)


def scatter_rows(pool: torch.Tensor, x: torch.Tensor, rows: Rows
                 ) -> torch.Tensor:
    """pool[block, offset] = x[b, s] (or x[b] for token rows) for every
    valid row, in place. Returns ``pool``."""
    *src, blk, off = rows_to(rows, pool.device)
    pool[blk, off] = x[tuple(src)].to(pool.dtype)
    return pool


def write_prompt(pool: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
                 lengths: torch.Tensor, block_size: int) -> torch.Tensor:
    """Scatter a padded prompt's per-token rows into one layer's pool.

    pool (n_blocks, bs, K, r); x (B, S, K, r); table (B, maxb) with -1
    padding; lengths (B,). Rows past a sequence's length and rows of
    unassigned table entries drop."""
    return scatter_rows(pool, x, prompt_rows(table, lengths, x.shape[1],
                                             block_size))


def write_token(pool: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
                pos: torch.Tensor, active: torch.Tensor,
                block_size: int) -> torch.Tensor:
    """Scatter one token per sequence. x (B, K, r); pos (B,) absolute token
    index; inactive rows drop."""
    return scatter_rows(pool, x, token_rows(table, pos, active, block_size))


def write_span(pool: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
               start: torch.Tensor, active: torch.Tensor,
               block_size: int) -> torch.Tensor:
    """Scatter ``S`` consecutive positions per sequence: x (B, S, K, r)
    holds positions ``start .. start + S - 1``. Inactive rows, unassigned
    table entries and positions past the table width drop."""
    return scatter_rows(pool, x, span_rows(table, start, active,
                                           x.shape[1], block_size))


def copy_cache_blocks(cache: dict, src: torch.Tensor,
                      dst: torch.Tensor) -> dict:
    """Block copies for copy-on-write forks: pool block ``src[i]`` ->
    ``dst[i]`` in EVERY layer's k and v pool, in place. Pad unused rows
    with ``dst = n_blocks`` (dropped); ``src`` is clamped for the read.
    A negative ``dst`` counts from the end, as a JAX scatter index does."""
    for name in ("k", "v"):
        pool = cache[name]                     # (L, nb, bs, K, r)
        nb = pool.shape[1]
        # the kept rows are chosen where src/dst lie (the host, for the
        # scheduler's lists), so a pool on the card is not synced
        s = src.long().clamp(0, nb - 1)
        d = dst.long()
        d = torch.where(d < 0, d + nb, d)
        keep = (d >= 0) & (d < nb)
        data = pool[:, s[keep].to(pool.device, non_blocking=True)]
        pool[:, d[keep].to(pool.device, non_blocking=True)] = data
    return cache


def gather_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather every sequence's cache view: (B, maxb*bs, K, r). Unassigned
    table entries read block 0 -- callers mask by context length."""
    B, maxb = table.shape
    g = pool[table.to(pool.device).long().clamp(min=0)]   # (B, maxb, bs, K, r)
    return g.reshape(B, maxb * g.shape[2], *g.shape[3:])
