"""Synchronous serving front-end: ``submit`` / ``step`` / ``drain``.

One :class:`Server` owns the paged pool (on its device), the scheduler
(host) and the paged step functions of ``runtime``. Every engine
iteration runs either one bucket-padded prefill over the newly admitted
requests or a decode window over all running slots, both at a fixed
``max_concurrency`` batch. Reports TTFT, TPOT, tokens/s and queue-depth
statistics from its own metrics registry.

With a draft model and ``spec_k > 0`` a decode step runs a speculative
window (draft k tokens, verify them in one target forward, commit the
accepted prefix over forked blocks); with a ``ChaosEngine`` the server
takes seeded faults at its hooks and retries the step they abort.

``paged_kernel`` ("auto" | "on" | "off", ``runtime.resolve_paged``) and
``prefill_backend`` ("auto" | "fold" | "reconstruct",
``runtime.resolve_prefill``) are the caller's explicit choice of decode
and CUR-KV prompt attention: the serve CLI's ``--paged-kernel`` and
``--prefill-backend`` arrive here as arguments, not through the
environment.

``mesh`` (a ``DeviceMesh``) serves on placed weights: the params (and a
draft's, per ``draft_param_pspecs``) are placed per ``param_pspecs`` and
both pools made as this rank's shards (``init_paged_cache(mesh=)``, the
kernel's kv-head layout) once, at construction; every rank submits the
same requests and gets the same tokens, each running its slots on its
shards. CUR-KV calibration runs on the whole params before placement.

PyTorch runs eagerly, so there is no compiled-step cache; the pow-2
prefill buckets stay, since they keep the flash kernel's sequence lengths
few.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import Placed, draft_param_pspecs, place
from repro_torch.models.model import place_on_entry
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import (
    ENGINE_TRACK, NULL_TRACER, Tracer, request_track)
from repro_torch.serving import paged_cache as pcache
from repro_torch.serving import runtime
from repro_torch.serving import speculative
from repro_torch.serving.resilience import (
    FAILURE_REASONS, DegradationLadder, QueueFull, ResilienceConfig,
    ServerWedged, deadline_expired, pressure_signals, ttft_missed)
from repro_torch.serving.sampling import (
    SamplingParams, greedy_tokens, pack_params, request_generator,
    sample_tokens)
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.testing.chaos import InjectedFault


def _bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power-of-two >= n, clamped to [lo, hi]."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def _mark(device: torch.device):
    """A point in time of ``device``'s work: a CUDA event recorded on the
    current stream, or on the CPU (where every op has run when it returns)
    the host clock. Marks time a window's phases without a device sync."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _seconds(a, b) -> float:
    """Seconds between two marks (CUDA events: once the stream passed b)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


class Server:
    def __init__(self, params, cfg: ModelConfig,
                 pc: Optional[pcache.PagedConfig] = None,
                 max_concurrency: int = 8,
                 calib_tokens=None, max_decode_window: int = 16,
                 draft_params=None, draft_cfg: Optional[ModelConfig] = None,
                 draft_pc: Optional[pcache.PagedConfig] = None,
                 spec_k: int = 0,
                 obs: Optional[Registry] = None,
                 tracer: Optional[Tracer] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 chaos=None, device=None, paged_kernel: str = "auto",
                 prefill_backend: Optional[str] = None, mesh=None):
        runtime.check_supported(cfg)
        self.device = resolve_device(device)
        self.paged_kernel = paged_kernel
        runtime.resolve_paged(self.device.type == "cuda", paged_kernel)
        self.params = params
        self.cfg = cfg
        self.pc = pc or pcache.PagedConfig()
        self.res = resilience or ResilienceConfig()
        # each Server owns an always-enabled registry (stats() derives
        # from its snapshot); pass one in to aggregate across servers
        self.obs = obs if obs is not None else Registry(enabled=True)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # out-of-window pool blocks are freed as decode advances only when
        # every attention layer is sliding-window -- in the target and,
        # under speculation, in the draft (they share one block table); both
        # local -> the larger window wins
        window = pcache.serving_window(cfg)
        if draft_params is not None and spec_k:
            dw = pcache.serving_window(draft_cfg or cfg)
            window = max(window, dw) if (window and dw) else 0
        self.window = window
        self.scheduler = Scheduler(self.pc, max_concurrency, obs=self.obs,
                                   tracer=self.tracer, window=self.window,
                                   max_queue=self.res.max_queue,
                                   overload_policy=self.res.overload_policy)
        self.ladder = DegradationLadder(self.res, obs=self.obs,
                                        tracer=self.tracer)
        self.chaos = chaos
        if chaos is not None:
            chaos.bind(obs=self.obs, tracer=self.tracer)
        self.cache = pcache.init_paged_cache(cfg, self.pc, self.device,
                                             mesh=mesh)
        if calib_tokens is None:
            gen = torch.Generator().manual_seed(0)
            calib_tokens = torch.randint(
                0, cfg.vocab_size, (2, min(64, self.pc.max_len)),
                generator=gen)
        calib_tokens = torch.as_tensor(np.asarray(calib_tokens))
        if self.pc.cur_kv:
            self.cache = runtime.calibrate_kv(
                params, cfg, self.pc, self.cache, calib_tokens)
        self._prefill_backend = runtime.resolve_prefill(
            prefill_backend).name
        self.max_decode_window = max_decode_window

        # --- speculative decoding (draft-k / verify-1) ----------------
        self.spec_k = int(spec_k) if draft_params is not None else 0
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg or (cfg if draft_params is not None
                                       else None)
        self.draft_pc = None
        self.draft_cache = None
        if self.spec_k > 0:
            runtime.check_supported(self.draft_cfg)
            # one block table indexes both pools: the draft pool takes the
            # target's block geometry (its per-block payload -- kv heads,
            # rank -- may differ)
            self.draft_pc = dataclasses.replace(
                draft_pc or self.pc, block_size=self.pc.block_size,
                n_blocks=self.pc.n_blocks,
                max_blocks_per_seq=self.pc.max_blocks_per_seq)
            self.draft_cache = pcache.init_paged_cache(
                self.draft_cfg, self.draft_pc, self.device, mesh=mesh)
            if self.draft_pc.cur_kv:
                self.draft_cache = runtime.calibrate_kv(
                    draft_params, self.draft_cfg, self.draft_pc,
                    self.draft_cache, calib_tokens)
        # under a mesh: params, draft params and both pools placed once
        # (the pools above; CUR-KV calibration ran on the whole params)
        self.mesh = self.draft_mesh = None
        if mesh is not None:
            self.params, self.mesh = place_on_entry(params, cfg, mesh)
            if self.spec_k > 0:
                specs = draft_param_pspecs(draft_params, self.draft_cfg,
                                           mesh)
                self.draft_params = place(draft_params, specs, mesh)
                self.draft_mesh = Placed(mesh, specs)

        self._next_rid = 0
        self.finished: Dict[int, Request] = {}
        self._t_start: Optional[float] = None
        self._step_idx = 0
        self._step_t0: Optional[float] = None   # last step start
        self._step_t1: Optional[float] = None   # last step end
        m = self.obs
        self._c_failed = m.counter(
            "repro_serving_requests_failed_total",
            "requests ending in a failure status", labels=("reason",))
        self._c_step_faults = m.counter(
            "repro_serving_step_faults_total",
            "engine steps aborted by a transient (injected) fault")
        self._c_tokens = m.counter(
            "repro_serving_tokens_generated_total", "tokens emitted")
        self._c_completed = m.counter(
            "repro_serving_requests_completed_total", "requests finished")
        self._c_prefill_steps = m.counter(
            "repro_serving_prefill_steps_total", "prefill engine steps")
        self._c_decode_steps = m.counter(
            "repro_serving_decode_steps_total", "decode engine steps")
        self._c_prefill_time = m.counter(
            "repro_serving_prefill_time_s_total", "seconds in prefill")
        self._c_decode_time = m.counter(
            "repro_serving_decode_time_s_total", "seconds in decode")
        self._c_prefill_tokens = m.counter(
            "repro_serving_prefill_tokens_total", "tokens from prefill")
        self._c_decode_tokens = m.counter(
            "repro_serving_decode_tokens_total", "tokens from decode")
        self._h_ttft = m.histogram(
            "repro_serving_ttft_s", "time to first token (s)")
        # submit -> first prefill: the load-dependent part of TTFT
        self._h_queue_wait = m.histogram(
            "repro_serving_queue_wait_s",
            "request wait from submission to first prefill (s)")
        self._h_tpot = m.histogram(
            "repro_serving_tpot_s",
            "per-token decode latency per step (s)")
        self._h_prefill_step = m.histogram(
            "repro_serving_prefill_step_s", "prefill step wall time (s)")
        self._h_decode_step = m.histogram(
            "repro_serving_decode_step_s", "decode step wall time (s)")
        self._h_queue_depth = m.histogram(
            "repro_serving_queue_depth",
            "admission queue depth sampled per engine step",
            buckets=tuple(float(2 ** i) for i in range(12)))
        # speculative split: draft vs verify device time, and the
        # model-level accept rate (accepted draft tokens / proposed)
        self._c_spec_windows = m.counter(
            "repro_serving_spec_windows_total", "speculative windows run")
        self._c_spec_fallbacks = m.counter(
            "repro_serving_spec_fallbacks_total",
            "windows that fell back to plain decode (pool too full)")
        self._c_spec_proposed = m.counter(
            "repro_serving_spec_tokens_proposed_total",
            "draft tokens proposed")
        self._c_spec_accepted = m.counter(
            "repro_serving_spec_tokens_accepted_total",
            "draft tokens accepted by verify")
        self._c_spec_draft_time = m.counter(
            "repro_serving_spec_draft_time_s_total", "seconds drafting")
        self._c_spec_verify_time = m.counter(
            "repro_serving_spec_verify_time_s_total", "seconds verifying")
        self._h_spec_accept = m.histogram(
            "repro_serving_spec_accept_rate",
            "per-window accepted/proposed ratio",
            buckets=tuple(i / 10 for i in range(11)))
        self._h_spec_window = m.histogram(
            "repro_serving_spec_window_tokens",
            "tokens committed per slot per speculative window",
            buckets=tuple(float(i) for i in range(1, 18)))

    # -- counter views ---------------------------------------------------
    @property
    def tokens_generated(self) -> int:
        return int(self._c_tokens.value)

    @property
    def n_prefill_steps(self) -> int:
        return int(self._c_prefill_steps.value)

    @property
    def n_decode_steps(self) -> int:
        return int(self._c_decode_steps.value)

    @property
    def prefill_time_s(self) -> float:
        return self._c_prefill_time.value

    @property
    def decode_time_s(self) -> float:
        return self._c_decode_time.value

    @property
    def prefill_tokens(self) -> int:
        return int(self._c_prefill_tokens.value)

    @property
    def decode_tokens(self) -> int:
        return int(self._c_decode_tokens.value)

    # -- request lifecycle ---------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               eos_id: Optional[int] = None,
               arrival: Optional[float] = None,
               priority: int = 0,
               ttft_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request; always returns its rid. A request turned
        away by bounded admission lands in ``finished`` with status
        ``"rejected"`` (a request shed to make room, ``"shed"``)."""
        rid = self._next_rid
        self._next_rid += 1
        if ttft_deadline_s is None:
            ttft_deadline_s = self.res.ttft_deadline_s or None
        if deadline_s is None:
            deadline_s = self.res.deadline_s or None
        req = Request(
            rid=rid, prompt=[int(t) for t in prompt],
            max_new_tokens=max_new_tokens,
            sampling=sampling or SamplingParams(), eos_id=eos_id,
            arrival=time.perf_counter() if arrival is None else arrival,
            priority=priority, ttft_deadline_s=ttft_deadline_s,
            deadline_s=deadline_s)
        try:
            victims = self.scheduler.add(req)
        except QueueFull:
            self._finalize(req, "rejected", time.perf_counter())
            return rid
        now = time.perf_counter()
        for v in victims:
            self._finalize(v, "shed", now)
        if self.tracer.enabled:
            self.tracer.name_track(request_track(rid), f"req {rid}")
            self.tracer.event("queued", track=request_track(rid),
                              rid=rid, prompt_len=len(req.prompt))
        return rid

    def _finalize(self, req: Request, reason: str, now: float) -> None:
        """Terminal failure status for a request not (or no longer)
        holding a slot: rejected / shed / timeout / cancelled."""
        req.finish_reason = reason
        req.finish_time = now
        self.finished[req.rid] = req
        self._c_failed.labels(reason=reason).inc()
        if self.tracer.enabled:
            self.tracer.add_span(
                "request", req.arrival, max(0.0, now - req.arrival),
                track=request_track(req.rid),
                attrs={"rid": req.rid, "reason": reason,
                       "tokens": len(req.out_tokens)})

    def cancel(self, rid: int) -> bool:
        """A queued request is dropped, a running one is retired with its
        pool blocks freed. False when the rid is unknown or finished."""
        now = time.perf_counter()
        dropped = self.scheduler.drop_queued(lambda r: r.rid == rid)
        if dropped:
            self._finalize(dropped[0], "cancelled", now)
            return True
        for i in list(self.scheduler.active_slots):
            if self.scheduler.slots[i].req.rid == rid:
                req = self.scheduler.retire(i)
                self._finalize(req, "cancelled", now)
                return True
        return False

    def health(self) -> dict:
        """Liveness/readiness probe (see the JAX package's Server)."""
        now = time.perf_counter()
        reasons = []
        wd = self.res.watchdog_s
        in_step = (self._step_t0 is not None
                   and (self._step_t1 is None
                        or self._step_t1 < self._step_t0))
        live = True
        if wd and in_step and now - self._step_t0 > wd:
            live = False
            reasons.append(
                f"step running {now - self._step_t0:.3f}s > "
                f"watchdog_s={wd}")
        ready = live
        depth = self.scheduler.queue_depth
        if self.res.max_queue and depth >= self.res.max_queue:
            ready = False
            reasons.append("admission queue full")
        if self.ladder.shed_active:
            ready = False
            reasons.append("degradation ladder at shed")
        return {
            "live": live, "ready": ready, "reasons": reasons,
            "degradation_level": self.ladder.level,
            "queue_depth": depth,
            "pool_blocks_free": self.scheduler.alloc.n_free,
            "pool_blocks_total": self.pc.n_blocks,
            "last_step_age_s": (None if self._step_t1 is None
                                else now - self._step_t1),
        }

    @property
    def idle(self) -> bool:
        return self.scheduler.idle

    # -- engine steps --------------------------------------------------
    def _slot_sampling(self):
        return [None if s is None else s.req.sampling
                for s in self.scheduler.slots]

    def _all_greedy(self) -> bool:
        return all(sp is None or sp.temperature <= 0.0
                   for sp in self._slot_sampling())

    def _sampling_arrays(self):
        """(seeds, rids, temps, top_ks, top_ps), one entry per slot."""
        B = self.scheduler.max_concurrency
        seeds = np.zeros((B,), np.int64)
        rids = np.zeros((B,), np.int64)
        for i, slot in enumerate(self.scheduler.slots):
            if slot is not None:
                seeds[i] = slot.req.sampling.seed
                rids[i] = slot.req.rid
        return (seeds, rids) + pack_params(self._slot_sampling(), B)

    def _sample_batch(self, logits, step_of):
        """Sample every slot row; argmax path when no live request needs
        temperature sampling. Returns numpy (tokens, logprobs)."""
        if self._all_greedy():
            toks, lps = greedy_tokens(logits)
        else:
            seeds, rids, temps, top_ks, top_ps = self._sampling_arrays()
            gens = []
            for i, slot in enumerate(self.scheduler.slots):
                step = 0 if slot is None else step_of(slot)
                gens.append(request_generator(seeds[i], rids[i], step,
                                              logits.device))
            dev = logits.device
            toks, lps = sample_tokens(logits, temps.to(dev),
                                      top_ks.to(dev), top_ps.to(dev), gens)
        return toks.cpu().numpy(), lps.float().cpu().numpy()

    def _maybe_retire(self, slot_id: int, now: float) -> None:
        slot = self.scheduler.slots[slot_id]
        req = slot.req
        if (req.eos_id is not None and req.out_tokens
                and req.out_tokens[-1] == req.eos_id):
            req.finish_reason = "eos"
        elif len(req.out_tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
        else:
            return
        req.finish_time = now
        self.scheduler.retire(slot_id)
        self.finished[req.rid] = req
        self._c_completed.inc()
        if self.tracer.enabled:
            self.tracer.add_span(
                "request", req.arrival, now - req.arrival,
                track=request_track(req.rid),
                attrs={"rid": req.rid, "reason": req.finish_reason,
                       "tokens": len(req.out_tokens),
                       "preempted": req.n_preempted})

    def _run_prefill(self, admitted, now: float) -> None:
        if self.chaos is not None:
            # fires BEFORE any cache/pool mutation: step() rolls the
            # admissions back and the retried step re-prefills bit-exactly
            self.chaos.site("prefill", self._step_idx)
        sched = self.scheduler
        B = sched.max_concurrency
        lengths = np.zeros((B,), np.int64)
        rows: Dict[int, List[int]] = {}
        for slot_id, req in admitted:
            toks = req.prompt + req.out_tokens[:-1] \
                if req.out_tokens else list(req.prompt)
            rows[slot_id] = toks
            lengths[slot_id] = len(toks)
        S = _bucket(int(lengths.max()), self.pc.block_size, self.pc.max_len)
        tokens = np.zeros((B, S), np.int64)
        for slot_id, toks in rows.items():
            tokens[slot_id, :len(toks)] = toks
        table = torch.from_numpy(sched.block_table())
        tokens, lengths = torch.from_numpy(tokens), torch.from_numpy(lengths)
        logits, self.cache = runtime.paged_prefill(
            self.params, self.cfg, self.pc, tokens, lengths, self.cache,
            table, self.mesh, backend=self._prefill_backend)
        if self.spec_k:
            # the draft shares the block table, so its pool must hold the
            # same prefix KV the target's does
            _, self.draft_cache = runtime.paged_prefill(
                self.draft_params, self.draft_cfg, self.draft_pc, tokens,
                lengths, self.draft_cache, table, self.draft_mesh,
                backend=self._prefill_backend)
        toks, lps = self._sample_batch(
            logits, lambda s: len(s.req.out_tokens))
        t_now = time.perf_counter()
        for slot_id, req in admitted:
            if self.tracer.enabled:
                if req.out_tokens:
                    self.tracer.add_span(
                        "restore", now, t_now - now,
                        track=request_track(req.rid),
                        attrs={"rid": req.rid})
                else:
                    self.tracer.add_span(
                        "queued", req.arrival, now - req.arrival,
                        track=request_track(req.rid),
                        attrs={"rid": req.rid})
            if req.out_tokens:
                # preemption restore: generated tokens already known; the
                # re-prefill only rebuilt the cache -- nothing to sample
                sched.slots[slot_id].next_token = req.out_tokens[-1]
                continue
            self._h_queue_wait.observe(now - req.arrival)
            req.ttft = t_now - req.arrival
            self._h_ttft.observe(req.ttft)
            req.out_tokens.append(int(toks[slot_id]))
            req.out_logprobs.append(float(lps[slot_id]))
            sched.slots[slot_id].next_token = req.out_tokens[-1]
            self._c_tokens.inc()
            self._maybe_retire(slot_id, t_now)
        self._c_prefill_steps.inc()

    def _decode_window(self) -> int:
        """Largest useful multi-step window: a power of two bounded by the
        largest remaining generation budget and ``max_decode_window``.
        Stop tokens force single-stepping."""
        sched = self.scheduler
        reqs = [sched.slots[i].req for i in sched.active_slots]
        if any(r.eos_id is not None for r in reqs):
            return 1
        rem = max(r.max_new_tokens - len(r.out_tokens) for r in reqs)
        k = 1
        while k * 2 <= min(rem, self.max_decode_window):
            k *= 2
        return k

    def _run_single_decode(self) -> None:
        sched = self.scheduler
        B = sched.max_concurrency
        next_toks = np.zeros((B, 1), np.int64)
        for i, slot in enumerate(sched.slots):
            if slot is not None:
                next_toks[i, 0] = slot.next_token
        next_toks = torch.from_numpy(next_toks)
        table = torch.from_numpy(sched.block_table())
        ctx = torch.from_numpy(sched.ctx_lens())
        active = torch.from_numpy(sched.active_mask())
        logits, self.cache = runtime.paged_decode(
            self.params, self.cfg, self.pc, next_toks, self.cache, table,
            ctx, active, self.mesh, self.paged_kernel)
        if self.spec_k:
            self._draft_sync(next_toks, table, ctx, active)
        toks, lps = self._sample_batch(
            logits, lambda s: len(s.req.out_tokens))
        t_now = time.perf_counter()
        for i in list(sched.active_slots):
            slot = sched.slots[i]
            slot.ctx_len += 1            # the input token is now cached
            slot.req.out_tokens.append(int(toks[i]))
            slot.req.out_logprobs.append(float(lps[i]))
            slot.next_token = slot.req.out_tokens[-1]
            self._c_tokens.inc()
            self._maybe_retire(i, t_now)
        self._c_decode_steps.inc()

    def _draft_sync(self, tokens, table, ctx, active) -> None:
        """Teacher-forced KV write through the draft model (its
        ``paged_verify``, logits unused): keeps the draft pool current
        across plain-decode windows, so the accept rate recovers instead of
        decaying after every fallback."""
        _, self.draft_cache = runtime.paged_verify(
            self.draft_params, self.draft_cfg, self.draft_pc, tokens,
            self.draft_cache, table, ctx, active, self.draft_mesh,
            self.paged_kernel)

    def _run_spec_decode(self) -> bool:
        """One draft-k/verify-1 window over all running slots. Returns
        False (without touching any device state) when the pool cannot fork
        the window: the caller falls back to plain decode, so speculation
        never causes a preemption. The window syncs the device once, when
        its tokens are read."""
        sched = self.scheduler
        k = self.spec_k
        fork = sched.fork_for_spec(k)
        if fork is None:
            self._c_spec_fallbacks.inc()
            self.tracer.event("spec_fallback", track=ENGINE_TRACK)
            return False
        B = sched.max_concurrency
        spec_table = np.full((B, self.pc.max_blocks_per_seq), -1, np.int32)
        for i, blocks in fork.tables.items():
            spec_table[i, :len(blocks)] = blocks
        if fork.copies:
            # boundary-block copy-on-write copies, <= 1 per slot, in both
            # pools (one block table indexes both)
            src = torch.tensor([s for s, _ in fork.copies])
            dst = torch.tensor([d for _, d in fork.copies])
            pcache.copy_cache_blocks(self.cache, src, dst)
            pcache.copy_cache_blocks(self.draft_cache, src, dst)

        next_toks = np.zeros((B, 1), np.int64)
        gen_starts = np.zeros((B,), np.int64)
        for i, slot in enumerate(sched.slots):
            if slot is not None:
                next_toks[i, 0] = slot.next_token
                gen_starts[i] = len(slot.req.out_tokens)
        table = torch.from_numpy(spec_table)
        ctx = torch.from_numpy(sched.ctx_lens())
        active = torch.from_numpy(sched.active_mask())
        greedy = self._all_greedy()
        sampling = None if greedy else self._sampling_arrays()

        t0 = time.perf_counter()
        m0 = _mark(self.device)
        d_toks, d_probs, self.draft_cache = speculative.draft_tokens(
            self.draft_params, self.draft_cfg, self.draft_pc,
            torch.from_numpy(next_toks), self.draft_cache, table, ctx,
            active, sampling, gen_starts, k, self.draft_mesh,
            greedy=greedy, paged_kernel=self.paged_kernel)
        m1 = _mark(self.device)
        ver_in = torch.cat([torch.from_numpy(next_toks).to(
            d_toks.device, non_blocking=True), d_toks], dim=1)
        emitted, n_emit, lps, self.cache = speculative.verify_tokens(
            self.params, self.cfg, self.pc, ver_in, d_toks, d_probs,
            self.cache, table, ctx, active, sampling, gen_starts, self.mesh,
            greedy=greedy, paged_kernel=self.paged_kernel)
        m2 = _mark(self.device)
        emitted = emitted.cpu().numpy()             # the window's one sync
        n_emit = n_emit.cpu().numpy()
        lps = lps.float().cpu().numpy()
        t_draft, t_verify = _seconds(m0, m1), _seconds(m1, m2)
        self._c_spec_draft_time.inc(t_draft)
        self._c_spec_verify_time.inc(t_verify)
        self.tracer.add_span("spec_draft", t0, t_draft,
                             track=ENGINE_TRACK, attrs={"k": k})
        self.tracer.add_span("spec_verify", t0 + t_draft, t_verify,
                             track=ENGINE_TRACK, attrs={"k": k})

        t_now = time.perf_counter()
        for i in list(sched.active_slots):
            slot = sched.slots[i]
            req = slot.req
            take = min(int(n_emit[i]),
                       req.max_new_tokens - len(req.out_tokens))
            row = [int(t) for t in emitted[i, :take]]
            if req.eos_id is not None and req.eos_id in row:
                # a spec window truncates at eos on the host: tokens past
                # it are never committed
                row = row[:row.index(req.eos_id) + 1]
                take = len(row)
            req.out_tokens.extend(row)
            req.out_logprobs.extend(float(lps[i, t]) for t in range(take))
            sched.commit_spec(i, fork.tables[i], take)
            slot.next_token = req.out_tokens[-1]
            self._c_tokens.inc(take)
            self._c_spec_proposed.inc(k)
            self._c_spec_accepted.inc(speculative.record_window(
                self._h_spec_accept, self._h_spec_window, k,
                int(n_emit[i]), take))
            self._maybe_retire(i, t_now)
        self._c_spec_windows.inc()
        self._c_decode_steps.inc()
        return True

    def _run_decode(self, now: float) -> None:
        if self.chaos is not None:
            # first line: an injected decode fault leaves every slot, block
            # list and pool untouched, so the step just retries
            self.chaos.site("decode", self._step_idx)
        sched = self.scheduler
        # drop out-of-window blocks BEFORE forking/reserving: the spec fork
        # path never calls ensure_decode_blocks
        sched.evict_out_of_window()
        # ladder step 1: speculation off under pressure (the window forks
        # blocks a strained pool cannot spare)
        if (self.spec_k and self.ladder.spec_allowed
                and self._run_spec_decode()):
            return
        # ladder step 2: shrink the multi-token window under pressure
        k = self.ladder.decode_window_cap(self._decode_window())
        remaining = {i: sched.slots[i].req.max_new_tokens
                     - len(sched.slots[i].req.out_tokens)
                     for i in sched.active_slots}
        # reserve blocks for each row's real write count inside the window
        sched.ensure_decode_blocks(
            per_slot={i: min(k, r) for i, r in remaining.items()})
        if k == 1:
            self._run_single_decode()
            return
        B = sched.max_concurrency
        next_toks = np.zeros((B, 1), np.int64)
        gen_starts = np.zeros((B,), np.int64)
        budgets = np.zeros((B,), np.int64)
        for i, slot in enumerate(sched.slots):
            if slot is not None:
                next_toks[i, 0] = slot.next_token
                gen_starts[i] = len(slot.req.out_tokens)
                budgets[i] = slot.req.max_new_tokens
        greedy = self._all_greedy()
        sampling = None if greedy else self._sampling_arrays()
        table = torch.from_numpy(sched.block_table())
        ctx = torch.from_numpy(sched.ctx_lens())
        active = torch.from_numpy(sched.active_mask())
        toks_seq, lps_seq, self.cache = runtime.paged_decode_scan(
            self.params, self.cfg, self.pc, torch.from_numpy(next_toks),
            self.cache, table, ctx, active, torch.from_numpy(budgets),
            sampling, torch.from_numpy(gen_starts), n_steps=k,
            mesh=self.mesh, greedy=greedy, paged_kernel=self.paged_kernel)
        toks_seq = toks_seq.cpu().numpy()          # the window's one sync
        lps_seq = lps_seq.float().cpu().numpy()
        if self.spec_k:
            # teacher-force the window's input tokens through the draft so
            # its pool stays current for the next speculative window (rows
            # that froze mid-window write past their committed context:
            # dead positions, overwritten later)
            self._draft_sync(torch.from_numpy(np.concatenate(
                [next_toks, toks_seq[:k - 1].T], axis=1)), table, ctx,
                active)
        t_now = time.perf_counter()
        for i in list(sched.active_slots):
            slot = sched.slots[i]
            take = min(k, remaining[i])
            for t in range(take):
                slot.ctx_len += 1        # the input token is now cached
                slot.req.out_tokens.append(int(toks_seq[t, i]))
                slot.req.out_logprobs.append(float(lps_seq[t, i]))
            self._c_tokens.inc(take)
            slot.next_token = slot.req.out_tokens[-1]
            self._maybe_retire(i, t_now)
        self._c_decode_steps.inc(k)

    # -- resilience passes (run inside step) ---------------------------
    def _expire_queued(self, now: float) -> None:
        """A queued request past its TTFT or total deadline is dropped
        before it costs a prefill."""
        for req in self.scheduler.drop_queued(
                lambda r: deadline_expired(r, now) is not None):
            self._finalize(req, "timeout", now)

    def _enforce_deadlines(self, now: float) -> None:
        """Cancel (freeing pool blocks) any running request past its total
        deadline or whose first token arrived after its TTFT deadline."""
        sched = self.scheduler
        for i in list(sched.active_slots):
            req = sched.slots[i].req
            if deadline_expired(req, now) or ttft_missed(req):
                sched.retire(i)
                self._finalize(req, "timeout", now)

    def _shed_for_pressure(self, now: float) -> None:
        """Ladder step 3: drop queued requests (per the overload policy)
        until queue pressure falls under the shed rung's exit."""
        sched = self.scheduler
        while sched.queue:
            pr = pressure_signals(sched, self.res.max_queue,
                                  sched.max_concurrency)
            if pr["queue"] < self.ladder.shed_exit_pressure:
                break
            if self.res.overload_policy == "priority":
                victim = min(sched.queue,
                             key=lambda r: (r.priority, r.arrival))
                sched.queue.remove(victim)
            else:
                victim = sched.queue.popleft()   # shed-oldest
            self._finalize(victim, "shed", now)

    def _watchdog(self, t0: float, kind: str) -> None:
        """Wall-clock bound per engine step: an over-budget step raises a
        typed ServerWedged with a diagnostic snapshot."""
        self._step_t1 = time.perf_counter()
        wd = self.res.watchdog_s
        dur = self._step_t1 - t0
        if wd and dur > wd:
            raise ServerWedged(
                f"engine step {self._step_idx} ({kind}) took {dur:.3f}s "
                f"> watchdog_s={wd}",
                {"step": self._step_idx, "kind": kind,
                 "duration_s": dur, "watchdog_s": wd,
                 "queue_depth": self.scheduler.queue_depth,
                 "active_slots": len(self.scheduler.active_slots),
                 "pool_blocks_free": self.scheduler.alloc.n_free,
                 "pool_blocks_total": self.pc.n_blocks,
                 "degradation_level": self.ladder.level})

    def step(self) -> bool:
        """One engine iteration. Returns False when nothing was runnable
        (chaos/deadline/ladder passes still run on such steps, so squeeze
        windows close and queued requests keep expiring)."""
        now = time.perf_counter()
        if self._t_start is None:
            self._t_start = now
        self._step_idx += 1
        self._step_t0 = now
        if self.chaos is not None:
            self.chaos.on_step(self, self._step_idx)
        self._h_queue_depth.observe(self.scheduler.queue_depth)
        self._expire_queued(now)
        pr = pressure_signals(self.scheduler, self.res.max_queue,
                              self.scheduler.max_concurrency)
        self.ladder.update(pr["pressure"], self._step_idx)
        if self.ladder.shed_active and self.res.overload_policy != "reject":
            self._shed_for_pressure(now)
        plan = self.scheduler.plan()
        toks_before = self.tokens_generated
        if plan.kind == "prefill":
            try:
                self._run_prefill(plan.prefill, now)
            except InjectedFault:
                self.scheduler.rollback_admission(plan.prefill)
                self._c_step_faults.inc()
                self._watchdog(now, "prefill_fault")
                return True
            dt = time.perf_counter() - now
            n = self.tokens_generated - toks_before
            self._c_prefill_time.inc(dt)
            self._c_prefill_tokens.inc(n)
            self._h_prefill_step.observe(dt)
            self.tracer.add_span("prefill", now, dt, track=ENGINE_TRACK,
                                 attrs={"admitted": len(plan.prefill),
                                        "tokens": n})
        elif plan.kind == "decode":
            try:
                self._run_decode(now)
            except InjectedFault:
                # the decode hook fires before any state mutates: slots,
                # block lists and pools are as planned, so the next step
                # retries the same window
                self._c_step_faults.inc()
                self._watchdog(now, "decode_fault")
                return True
            dt = time.perf_counter() - now
            n = self.tokens_generated - toks_before
            self._c_decode_time.inc(dt)
            self._c_decode_tokens.inc(n)
            self._h_decode_step.observe(dt)
            if n > 0:
                self._h_tpot.observe(dt / n)
            self.tracer.add_span("decode_window", now, dt,
                                 track=ENGINE_TRACK, attrs={"tokens": n})
        else:
            self._watchdog(now, "idle")
            return False
        self._enforce_deadlines(time.perf_counter())
        self._watchdog(now, plan.kind)
        return True

    def drain(self) -> Dict[int, Request]:
        """Run until queue and slots are empty; returns finished requests."""
        while not self.idle:
            if not self.step():
                break
        return self.finished

    # -- reporting -----------------------------------------------------
    def cache_bytes(self) -> int:
        return pcache.cache_bytes(self.cache)

    def stats(self) -> dict:
        """Serving report, derived from the obs registry snapshot; the
        JAX package's Server reports the same keys (``jit_cache`` is all 0:
        nothing is compiled)."""
        snap = self.obs.snapshot()

        def val(name, default=0.0):
            s = snap.get(name)
            return s["value"] if s else default

        def hist(name):
            return snap.get(name) or {
                "count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                "max": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}

        elapsed = (time.perf_counter() - self._t_start
                   if self._t_start is not None else 0.0)
        tokens = int(val("repro_serving_tokens_generated_total"))
        prefill_t = val("repro_serving_prefill_time_s_total")
        decode_t = val("repro_serving_decode_time_s_total")
        busy = prefill_t + decode_t
        decode_toks = int(val("repro_serving_decode_tokens_total"))
        proposed = val("repro_serving_spec_tokens_proposed_total")
        ttft, tpot, qd = (hist("repro_serving_ttft_s"),
                          hist("repro_serving_tpot_s"),
                          hist("repro_serving_queue_depth"))
        qw = hist("repro_serving_queue_wait_s")
        on_cuda = self.cache["k"].is_cuda
        paged = runtime.resolve_paged(on_cuda, self.paged_kernel).name
        return {
            "completed": int(
                val("repro_serving_requests_completed_total")),
            "tokens_generated": tokens,
            "elapsed_s": elapsed,
            "tokens_per_s": tokens / elapsed if elapsed > 0 else 0.0,
            "busy_time_s": busy,
            "tokens_per_s_busy": tokens / busy if busy > 0 else 0.0,
            "ttft_mean_s": ttft["mean"],
            "ttft_max_s": ttft["max"],
            "ttft_p50_s": ttft["p50"],
            "ttft_p90_s": ttft["p90"],
            "ttft_p99_s": ttft["p99"],
            "tpot_p50_s": tpot["p50"],
            "tpot_p99_s": tpot["p99"],
            "queue_wait_mean_s": qw["mean"],
            "queue_wait_p50_s": qw["p50"],
            "queue_wait_p99_s": qw["p99"],
            "queue_wait_total_s": qw["sum"],
            "queue_depth_mean": qd["mean"],
            "queue_depth_max": int(qd["max"]),
            "n_prefill_steps": int(
                val("repro_serving_prefill_steps_total")),
            "n_decode_steps": int(
                val("repro_serving_decode_steps_total")),
            "n_preemptions": self.scheduler.n_preemptions,
            "cache_bytes": self.cache_bytes(),
            "pool_blocks_used": int(
                val("repro_serving_pool_blocks_used")),
            "pool_blocks_total": self.pc.n_blocks,
            "prefill_time_s": prefill_t,
            "decode_time_s": decode_t,
            "decode_tok_s": (decode_toks / decode_t
                             if decode_t > 0 else 0.0),
            "gathered_bytes_per_step": runtime.gathered_bytes_per_step(
                self.cfg, self.pc, self.scheduler.max_concurrency,
                paged == "paged_cuda"),
            "attn_backends": {
                "paged_decode": paged,
                "paged_prefill": self._prefill_backend,
            },
            "prefill_backend": self._prefill_backend,
            "reconstructed_bytes_per_prefill":
                runtime.reconstructed_bytes_per_prefill(
                    self.cfg, self.pc, self.scheduler.max_concurrency,
                    self.pc.max_len, backend=self._prefill_backend),
            "window": self.window,
            "window_blocks_freed":
                self.scheduler.alloc.blocks_freed_window,
            "spec_k": self.spec_k,
            "n_spec_windows": int(
                val("repro_serving_spec_windows_total")),
            "n_spec_fallbacks": int(
                val("repro_serving_spec_fallbacks_total")),
            "spec_accept_rate": (
                val("repro_serving_spec_tokens_accepted_total") / proposed
                if proposed else 0.0),
            "spec_draft_time_s": val(
                "repro_serving_spec_draft_time_s_total"),
            "spec_verify_time_s": val(
                "repro_serving_spec_verify_time_s_total"),
            "jit_cache": {"hits": 0, "misses": 0, "evictions": 0,
                          "size": 0},
            "failed": {r: int(self._c_failed.labels(reason=r).value)
                       for r in FAILURE_REASONS},
            "step_faults": int(
                val("repro_serving_step_faults_total")),
            "degradation_level": self.ladder.level,
            "degradation_transitions": len(self.ladder.transitions),
            "max_queue": self.res.max_queue,
            "overload_policy": self.res.overload_policy,
        }
