"""Continuous-batching scheduler: admission queue, slot table, preemption.

Pure host-side bookkeeping — the scheduler never touches device arrays.
Each engine iteration it emits one :class:`Plan`:

  - ``prefill``: newly admitted requests (slot, request) whose prompts
    (plus, for preemption-restored requests, their already-generated
    tokens) are prefetched into freshly allocated blocks in one ragged,
    bucket-padded batch;
  - ``decode``: one token for every running slot;
  - ``idle``: nothing runnable (queue empty or blocked on arrivals).

Prefill has priority (vLLM-style): admitting early keeps the decode batch
full. When the block pool runs dry mid-decode, the most-recently-admitted
victim is preempted by eviction — all its blocks are freed and it rejoins
the *front* of the queue carrying its generated tokens, so re-admission
re-prefills prompt+generated and decoding continues bit-exactly.

Sliding-window serving (``window > 0``, fully-local stacks only — see
``paged_cache.serving_window``): blocks wholly behind the window are
freed as decode advances (the window mask is monotone in ``ctx_len``, so
a dead block is dead forever) and admission skips the dead prefix of
long prompts outright. Freed/skipped entries stay in ``Slot.blocks`` as
``-1`` holes — the list keeps one entry per block *index* so capacity
math and ``t // bs`` table lookups are unchanged, while live pool
occupancy per slot is O(window) instead of O(ctx_len). The device side
already treats holes as dead: reads mask ``blk < 0``, writes drop.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.paged_cache import BlockAllocator, PagedConfig
from repro_torch.serving.resilience import OVERLOAD_POLICIES, QueueFull
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    eos_id: Optional[int] = None
    arrival: float = 0.0
    priority: int = 0                     # higher = shed later
    ttft_deadline_s: Optional[float] = None   # relative to arrival
    deadline_s: Optional[float] = None        # relative to arrival
    # --- filled by the runtime ---------------------------------------
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    out_logprobs: List[float] = dataclasses.field(default_factory=list)
    ttft: Optional[float] = None          # first-token latency (s)
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None   # "eos"|"length"|failure status
    n_preempted: int = 0

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


@dataclasses.dataclass
class Slot:
    req: Request
    blocks: List[int]
    ctx_len: int            # tokens currently materialized in the pool
    next_token: int         # sampled but not yet written to the pool
    admit_seq: int          # admission order (newest preempted first)


@dataclasses.dataclass
class SpecFork:
    """A speculative window's forked block state: per-slot forked block
    lists (shared ids + private replacements for written-range blocks)
    and the (src, dst) device copies the caller must apply to every pool
    before drafting into ``tables``."""
    tables: Dict[int, List[int]]
    copies: List[Tuple[int, int]]


@dataclasses.dataclass
class Plan:
    kind: str                                   # "prefill"|"decode"|"idle"
    prefill: List[Tuple[int, Request]] = dataclasses.field(
        default_factory=list)


class Scheduler:
    def __init__(self, pc: PagedConfig, max_concurrency: int, obs=None,
                 tracer=None, window: int = 0, max_queue: int = 0,
                 overload_policy: str = "reject"):
        if overload_policy not in OVERLOAD_POLICIES:
            raise ValueError(f"overload_policy {overload_policy!r} not "
                             f"in {OVERLOAD_POLICIES}")
        self.pc = pc
        self.max_concurrency = max_concurrency
        self.window = window          # 0 = no eviction (full context)
        self.max_queue = max_queue    # 0 = unbounded (legacy)
        self.overload_policy = overload_policy
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Slot]] = [None] * max_concurrency
        self.alloc = BlockAllocator(pc.n_blocks, obs=obs)
        self.tracer = tracer
        self._admit_seq = 0
        self.n_preemptions = 0
        if obs is None:
            from repro_torch.obs.metrics import NULL
            self._m_preempt = NULL
        else:
            self._m_preempt = obs.counter(
                "repro_serving_preemptions_total",
                "slots evicted on pool exhaustion")

    # -- introspection -------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active_slots

    # -- admission -----------------------------------------------------
    def add(self, req: Request) -> List[Request]:
        """Enqueue ``req``. With a bounded queue (``max_queue > 0``) at
        capacity, the overload policy decides: ``reject`` raises
        :class:`QueueFull`; ``shed-oldest`` drops the oldest queued
        request; ``priority`` drops the oldest lowest-priority queued
        request, or raises QueueFull when the newcomer itself is the
        lowest class. Returns the shed victims (callers finalize them
        with a terminal ``"shed"`` status). Preempted requests rejoin
        via ``appendleft`` without passing through this gate — they
        already hold admission."""
        need = self.pc.blocks_for(len(req.prompt) + req.max_new_tokens)
        if need > self.pc.n_blocks or need > self.pc.max_blocks_per_seq:
            raise ValueError(
                f"request {req.rid}: {len(req.prompt)}+{req.max_new_tokens}"
                f" tokens exceed the pool "
                f"({self.pc.n_blocks}x{self.pc.block_size} blocks, "
                f"table width {self.pc.max_blocks_per_seq})")
        victims: List[Request] = []
        while self.max_queue > 0 and len(self.queue) >= self.max_queue:
            victim = self._overload_victim(req)
            if victim is None:
                raise QueueFull(req.rid, len(self.queue), self.max_queue)
            self.queue.remove(victim)
            victims.append(victim)
        self.queue.append(req)
        return victims

    def _overload_victim(self, incoming: Request) -> Optional[Request]:
        """Who a full queue sheds to admit ``incoming`` — None means
        nobody (reject the newcomer instead)."""
        if self.overload_policy == "reject" or not self.queue:
            return None
        if self.overload_policy == "shed-oldest":
            return self.queue[0]
        # priority: oldest of the lowest class, only if strictly below
        # the newcomer (equal-class arrivals are FIFO: newcomer loses)
        victim = min(self.queue, key=lambda r: r.priority)
        return victim if victim.priority < incoming.priority else None

    def drop_queued(self, pred) -> List[Request]:
        """Remove every queued request matching ``pred`` (deadline
        expiry, pressure shedding). Active slots are untouched."""
        dropped = [r for r in self.queue if pred(r)]
        if dropped:
            self.queue = deque(r for r in self.queue if not pred(r))
        return dropped

    def rollback_admission(self,
                           admitted: List[Tuple[int, Request]]) -> None:
        """Undo ``_try_admit`` after a failed prefill (e.g. an injected
        transient fault): free each slot's blocks and put the requests
        back at the queue front in their original order, so the retried
        step re-admits and re-prefills them bit-exactly."""
        for slot_id, req in reversed(admitted):
            slot = self.slots[slot_id]
            if slot is None or slot.req is not req:
                continue
            self.alloc.free(self._live(slot.blocks))
            self.slots[slot_id] = None
            self.queue.appendleft(req)

    def _prefill_len(self, req: Request) -> int:
        """Tokens to materialize on (re-)admission: prompt plus all
        generated-but-one (the last generated token is the next decode
        input, exactly as if the request was never preempted)."""
        return len(req.prompt) + max(0, len(req.out_tokens) - 1)

    def admission_blocks_needed(self, req: Request) -> int:
        """Pool blocks admission would have to allocate for ``req``: the
        prefill length plus one decode-headroom token, minus the dead
        window prefix (window mode never materializes it — its
        write_prompt scatters drop on the -1 holes and decode can never
        attend it; prefill attention itself runs on in-flight K/V, not
        the pool)."""
        n_pre = self._prefill_len(req)
        need = self.pc.blocks_for(n_pre + 1)
        first_live = 0
        if self.window > 0:
            first_live = max(0, n_pre - self.window + 1) \
                // self.pc.block_size
        return need - first_live

    def _try_admit(self) -> List[Tuple[int, Request]]:
        admitted = []
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        while self.queue and free_slots:
            req = self.queue[0]
            n_pre = self._prefill_len(req)
            first_live = 0
            if self.window > 0:
                first_live = max(0, n_pre - self.window + 1) \
                    // self.pc.block_size
            blocks = self.alloc.alloc(
                self.admission_blocks_needed(req))
            if blocks is None:
                break
            self.queue.popleft()
            slot_id = free_slots.pop(0)
            self.slots[slot_id] = Slot(
                req=req, blocks=[-1] * first_live + blocks, ctx_len=n_pre,
                next_token=(req.out_tokens[-1] if req.out_tokens else -1),
                admit_seq=self._admit_seq)
            self._admit_seq += 1
            admitted.append((slot_id, req))
        return admitted

    # -- decode capacity / preemption ----------------------------------
    def evict_out_of_window(self) -> int:
        """Free every active slot's blocks that fell wholly behind the
        sliding window (no-op when ``window == 0``). Returns blocks
        freed; called each step before growing block lists so decode pool
        occupancy stays O(window) per slot."""
        if self.window <= 0:
            return 0
        n = 0
        for i in self.active_slots:
            slot = self.slots[i]
            n += self.alloc.free_window(slot.blocks, slot.ctx_len,
                                        self.window, self.pc.block_size)
        return n

    def ensure_decode_blocks(self, lookahead: int = 1,
                             per_slot=None) -> None:
        """Every active slot is about to write tokens
        ``ctx_len .. ctx_len + lookahead - 1`` (``per_slot`` overrides
        the window per slot id, e.g. trimmed to a request's remaining
        budget); grow its block list to cover them. On pool exhaustion,
        evict the newest-admitted other slot and retry."""
        self.evict_out_of_window()
        for i in sorted(self.active_slots,
                        key=lambda j: self.slots[j].admit_seq):
            slot = self.slots[i]
            if slot is None:          # preempted earlier in this pass
                continue
            la = per_slot.get(i, lookahead) if per_slot else lookahead
            last = max(la, 1) - 1
            while (len(slot.blocks) * self.pc.block_size
                   <= slot.ctx_len + last):
                fresh = self.alloc.alloc(1)
                if fresh is not None:
                    slot.blocks.extend(fresh)
                    continue
                victim = self._pick_victim(exclude=i)
                if victim is None:
                    raise RuntimeError(
                        "paged pool exhausted with a single sequence "
                        "running — pool is too small for the workload")
                self._preempt(victim)

    def _pick_victim(self, exclude: int) -> Optional[int]:
        cands = [i for i in self.active_slots if i != exclude]
        if not cands:
            return None
        return max(cands, key=lambda i: self.slots[i].admit_seq)

    @staticmethod
    def _live(blocks: List[int]) -> List[int]:
        """Allocator-facing view of a block list: window holes excluded."""
        return [b for b in blocks if b >= 0]

    def _preempt(self, slot_id: int) -> None:
        slot = self.slots[slot_id]
        self.alloc.free(self._live(slot.blocks))
        self.slots[slot_id] = None
        slot.req.n_preempted += 1
        self.n_preemptions += 1
        self._m_preempt.inc()
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event("preempt", track=slot.req.rid + 1,
                              rid=slot.req.rid,
                              generated=len(slot.req.out_tokens))
        self.queue.appendleft(slot.req)

    # -- speculative fork / commit -------------------------------------
    def fork_for_spec(self, k: int) -> Optional[SpecFork]:
        """Fork every active slot's block list for a k-token speculative
        window (the verify forward writes positions
        ``ctx_len .. ctx_len + k``). Blocks in that write range are never
        left shared: the boundary block (which still holds live parent
        positions when ``ctx_len % block_size != 0``) is copy-on-write'd
        with a device copy scheduled in ``SpecFork.copies``; other shared
        blocks in the range hold only dead parent data, so they are
        swapped for fresh blocks without copying. Fresh blocks extend
        coverage to the window's last position.

        Returns None — with every refcount rolled back — when the pool
        cannot cover the window; the caller falls back to plain decode.
        Speculation never preempts."""
        bs = self.pc.block_size
        tables: Dict[int, List[int]] = {}
        copies: List[Tuple[int, int]] = []
        forked: List[List[int]] = []

        def rollback() -> None:
            for blocks in forked:
                self.alloc.free(self._live(blocks))

        for i in self.active_slots:
            slot = self.slots[i]
            c = slot.ctx_len
            last = min(c + k, self.pc.max_len - 1)
            # window holes are shared verbatim (-1 stays -1; there is no
            # block to fork) — the write range below is always live, so
            # holes never need CoW
            self.alloc.fork(self._live(slot.blocks))
            spec = list(slot.blocks)
            forked.append(spec)
            for bi in range(c // bs, min(last // bs, len(spec) - 1) + 1):
                old = spec[bi]
                if self.alloc.ref(old) <= 1:
                    continue
                nb = self.alloc.copy_on_write(old)
                if nb is None:
                    rollback()
                    return None
                if bi == c // bs and c % bs:
                    # live parent positions < c share this block: the
                    # private replacement needs their data
                    copies.append((old, nb))
                spec[bi] = nb
            while len(spec) * bs <= last:
                fresh = self.alloc.alloc(1)
                if fresh is None:
                    rollback()
                    return None
                spec.extend(fresh)
            tables[i] = spec
        return SpecFork(tables=tables, copies=copies)

    def commit_spec(self, slot_id: int, spec_blocks: List[int],
                    n_tokens: int) -> None:
        """Adopt a slot's forked list after ``n_tokens`` accepted
        positions: advance ``ctx_len``, free the parent's list, and trim
        fork blocks past the next write position back to the pool."""
        slot = self.slots[slot_id]
        old = slot.blocks
        slot.ctx_len += n_tokens
        keep = min(len(spec_blocks),
                   slot.ctx_len // self.pc.block_size + 1)
        slot.blocks = spec_blocks[:keep]
        if spec_blocks[keep:]:
            self.alloc.free(self._live(spec_blocks[keep:]))
        self.alloc.free(self._live(old))

    def abort_spec(self, fork: SpecFork) -> None:
        """Roll a fork back (e.g. after a failed device step): drop every
        forked reference; parents are untouched."""
        for blocks in fork.tables.values():
            self.alloc.free(self._live(blocks))

    # -- retirement ----------------------------------------------------
    def retire(self, slot_id: int) -> Request:
        slot = self.slots[slot_id]
        self.alloc.free(self._live(slot.blocks))
        self.slots[slot_id] = None
        return slot.req

    # -- planning ------------------------------------------------------
    def plan(self) -> Plan:
        """Admission first (keeps the decode batch full); the caller
        reserves decode blocks via ``ensure_decode_blocks`` once it has
        chosen its lookahead window."""
        admitted = self._try_admit()
        if admitted:
            return Plan(kind="prefill", prefill=admitted)
        if self.active_slots:
            return Plan(kind="decode")
        return Plan(kind="idle")

    # -- dense views for the jitted steps ------------------------------
    def block_table(self):
        """(B, maxb) int32 numpy table, -1 padded."""
        t = np.full((self.max_concurrency, self.pc.max_blocks_per_seq),
                    -1, np.int32)
        for i, slot in enumerate(self.slots):
            if slot is not None:
                t[i, :len(slot.blocks)] = slot.blocks
        return t

    def ctx_lens(self):
        return np.array(
            [0 if s is None else s.ctx_len for s in self.slots], np.int32)

    def active_mask(self):
        return np.array([s is not None for s in self.slots], bool)
