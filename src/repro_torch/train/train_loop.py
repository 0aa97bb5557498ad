"""Training loop: the train step with optional microbatch gradient
accumulation, error-feedback int8 gradient compression, a straggler
watchdog, and checkpoint-manager hooks (``repro.train.train_loop`` in the
JAX package).

The step is eager PyTorch (JAX jits it): gradients come from
``torch.autograd.grad`` over detached aliases of the parameters
(``repro_torch.core.heal.value_and_grad``), and the update is AdamW's
functional one. Microbatches are a Python loop whose loss and gradients
are the means over the microbatches, as JAX's ``lax.scan`` gives them.

Under a mesh (JAX: GSPMD under ``jit``) the step runs on placed params:
each rank holds its shards of the weights, gradients and moments
(``repro_torch.dist.sharding.place``; Megatron TP over 'model', FSDP over
'data' for ``cfg.fsdp``). ``mesh`` is a ``Placed`` (the caller placed the
params and the optimizer state, and the step returns them placed) or a
plain ``DeviceMesh`` (replicated params: the step places them on entry
and all-gathers what it returns, so every rank gets whole trees). Every
rank passes the same global batch. Micro-batch i is the global rows
``[i * micro, (i + 1) * micro)``, of which a rank takes its rows per
``batch_pspecs`` (all of them where ``micro`` does not divide over the
batch axes). The loss is JAX's global masked mean: per micro-batch, the
masked sum of log-likelihoods and the mask's count are all-reduced over
the batch axes as one f32 pair, each rank differentiates ``local_sum /
max(global_count, 1)``, and the gradients are summed over the batch axes
per leaf by its spec: an FSDP leaf's arrive summed over 'data' through
its gather's backward; the others go through one f32 all-reduce of the
concatenated leaves (or ``ef_psum_grads`` under error feedback, each rank
keeping residuals shaped like its shards); a leaf sharded over 'model'
needs no reduction there. Every rank then updates only its shards.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional

import torch

from repro_torch.bridge import flatten_up_to, unflatten_as
from repro_torch.configs.base import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.core.heal import value_and_grad
from repro_torch.dist.collectives import all_reduce, dp_axes
from repro_torch.dist.compression import (
    ef_compress_grads, ef_psum_grads, init_residuals)
from repro_torch.dist.sharding import (
    Placed, param_pspecs, place, shard_batch, spec_axes, state_specs,
    unplace)
from repro_torch.models.model import loss_fn, loss_sums
from repro_torch.optim.adamw import AdamW


def make_train_step(cfg: ModelConfig, opt: AdamW,
                    train_cfg: Optional[TrainConfig] = None, mesh=None,
                    loss=loss_fn):
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss).

    With train_cfg.microbatch > 0 the global batch is split into
    micro-batches whose gradients are averaged: activation memory scales
    with the micro-batch. ``mesh``: see the module docstring."""
    return _make_step(cfg, opt, train_cfg, mesh, loss, compress=False)


def make_ef_train_step(cfg: ModelConfig, opt: AdamW,
                       train_cfg: Optional[TrainConfig] = None, mesh=None,
                       loss=loss_fn):
    """Train step with error-feedback int8 gradient compression
    (TrainConfig.grad_compress == "ef_int8"): the gradient is replaced by
    its wire format and the quantization residual is carried between
    steps. Returns step(params, opt_state, residuals, batch) -> (params,
    opt_state, residuals, loss); initialize residuals with
    ``repro_torch.dist.compression.init_residuals(params)``. Under a
    ``mesh`` the gradients are summed over the batch axes through
    ``compressed_psum``."""
    return _make_step(cfg, opt, train_cfg, mesh, loss, compress=True)


def make_grads_fn(cfg: ModelConfig, train_cfg: Optional[TrainConfig] = None,
                  mesh=None, loss=loss_fn):
    """(params, batch) -> (loss, grads) of the step without compression:
    under a ``mesh``, the gradient every rank's update applies (placed
    like the params: shards under a ``Placed``, whole trees under a
    ``DeviceMesh``)."""
    micro = train_cfg.microbatch if train_cfg else 0
    if mesh is None:
        return _make_grads_fn(lambda p, b: loss(p, cfg, b), micro)
    local = _local_grads_fn(cfg, micro, loss)

    def grads_of(params, batch):
        lay, whole = _layout(params, cfg, mesh)
        if whole:
            params = _moved(place, lay, params)[0]
        l, grads = local(params, batch, lay)
        grads = _sum_grads(grads, lay)
        return l, (_moved(unplace, lay, grads)[0] if whole else grads)

    return grads_of


def _layout(params, cfg, mesh):
    """(the ``Placed`` the step runs under, whether ``params`` are whole
    trees to place on entry)."""
    if isinstance(mesh, Placed):
        return dataclasses.replace(mesh, local_rows=True), False
    return Placed(mesh, param_pspecs(params, cfg, mesh), True), True


def _moved(move, lay, params, opt_state=None, residuals=None):
    """(params, opt_state, residuals) each through ``move`` (:func:`place`
    or :func:`unplace`) per ``lay``'s specs: the moments and int8 scales
    per :func:`state_specs`, the EF residuals like the params."""
    m, specs = lay.mesh, lay.specs
    if opt_state is not None:
        opt_state = move(opt_state, state_specs(params, specs, opt_state), m)
    if residuals is not None:
        residuals = move(residuals, specs, m)
    return move(params, specs, m), opt_state, residuals


def _local_grads_fn(cfg, micro, loss):
    """(placed params, global batch, Placed) -> (loss, this rank's
    gradients before the sum over the batch axes), the loss being JAX's
    global masked mean (see the module docstring)."""
    if loss is not loss_fn:
        raise NotImplementedError(
            "a mesh train step takes loss_fn's global masked mean")

    def one(params, batch, lay):
        mb = shard_batch(batch, cfg, lay.mesh)
        pair = []

        def f(p):
            total, count = loss_sums(p, cfg, mb, lay)
            both = all_reduce(torch.stack([total.detach(), count]),
                              lay.mesh, dp_axes(lay.mesh))
            pair.append(both)
            return total / torch.clamp(both[1], min=1.0)

        _, grads = value_and_grad(f, params)
        return pair[0][0] / torch.clamp(pair[0][1], min=1.0), grads

    def local(params, batch, lay):
        B = batch["labels"].shape[0]
        if not (micro and B > micro):
            return one(params, batch, lay)
        n = B // micro
        l_sum, g_sum = 0.0, None
        for i in range(n):
            mb = {k: v.reshape((n, micro) + v.shape[1:])[i]
                  for k, v in batch.items()}
            l, g = one(params, mb, lay)
            g = flatten_up_to(params, g)
            l_sum = l_sum + l
            g_sum = g if g_sum is None else [
                None if a is None else a + b for a, b in zip(g_sum, g)]
        return l_sum / n, unflatten_as(
            params, [None if a is None else a / n for a in g_sum])

    return local


def _sum_grads(grads, lay):
    """Every rank's gradients summed over the batch axes a leaf is not
    sharded on (an FSDP leaf's sum over 'data' came with its gather's
    backward): one f32 all-reduce of the concatenated leaves per set of
    axes."""
    dp = dp_axes(lay.mesh)
    flat = flatten_up_to(grads, grads)
    groups = {}
    for i, (g, spec) in enumerate(zip(flat, flatten_up_to(grads,
                                                          lay.specs))):
        axes = tuple(a for a in dp if a not in spec_axes(spec))
        if g is not None and axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        buf = torch.cat([flat[i].to(torch.float32).reshape(-1)
                         for i in idx])
        all_reduce(buf, lay.mesh, axes)
        for i, part in zip(idx, buf.split([flat[i].numel() for i in idx])):
            flat[i] = part.view(flat[i].shape).to(flat[i].dtype)
    return unflatten_as(grads, flat)


def _make_step(cfg, opt, train_cfg, mesh, loss, *, compress: bool):
    """One factory behind both steps: only the EF hook and the threaded
    residuals differ."""
    micro = train_cfg.microbatch if train_cfg else 0
    if mesh is None:
        grads_of = _make_grads_fn(lambda p, b: loss(p, cfg, b), micro)

        def step(params, opt_state, residuals, batch):
            l, grads = grads_of(params, batch)
            if compress:
                grads, residuals = ef_compress_grads(grads, residuals)
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, residuals, l
    else:
        local = _local_grads_fn(cfg, micro, loss)

        def step(params, opt_state, residuals, batch):
            lay, whole = _layout(params, cfg, mesh)
            if whole:
                params, opt_state, residuals = _moved(
                    place, lay, params, opt_state, residuals)
            l, grads = local(params, batch, lay)
            if compress:
                grads, residuals = ef_psum_grads(
                    grads, residuals, lay.mesh, dp_axes(lay.mesh), lay.specs)
            else:
                grads = _sum_grads(grads, lay)
            params, opt_state = opt.update(params, grads, opt_state, lay)
            if whole:
                params, opt_state, residuals = _moved(
                    unplace, lay, params, opt_state, residuals)
            return params, opt_state, residuals, l
    if compress:
        return step

    def plain_step(params, opt_state, batch):
        params, opt_state, _, l = step(params, opt_state, None, batch)
        return params, opt_state, l

    return plain_step


def _make_grads_fn(loss_of, micro: int):
    """(params, batch) -> (loss, grads), averaged over micro-batches when
    the batch holds more than ``micro`` rows (a running sum, so one
    gradient tree is held beside the micro-batch's)."""
    def grads_of(params, batch):
        B = batch["labels"].shape[0]
        if not (micro and B > micro):
            return value_and_grad(lambda p: loss_of(p, batch), params)
        n = B // micro
        l_sum, g_sum = 0.0, None
        for i in range(n):
            mb = {k: v.reshape((n, micro) + v.shape[1:])[i]
                  for k, v in batch.items()}
            l, g = value_and_grad(lambda p: loss_of(p, mb), params)
            g = flatten_up_to(params, g)
            l_sum = l_sum + l
            g_sum = g if g_sum is None else [
                None if a is None else a + b for a, b in zip(g_sum, g)]
        return l_sum / n, unflatten_as(
            params, [None if a is None else a / n for a in g_sum])
    return grads_of


# ---------------------------------------------------------------------------
# straggler watchdog (fault-tolerance substrate)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the rolling median. At fleet
    scale the flag feeds the pod-replacement controller; here it logs."""
    window: int = 32
    threshold: float = 3.0

    def __post_init__(self):
        self._times = []
        self.flagged = []

    def observe(self, step: int, seconds: float) -> bool:
        slow = False
        if len(self._times) >= 8:
            med = statistics.median(self._times[-self.window:])
            slow = seconds > self.threshold * med
            if slow:
                self.flagged.append((step, seconds, med))
        self._times.append(seconds)
        return slow


def train(params, cfg, opt_cfg: OptimizerConfig, batches,
          train_cfg: Optional[TrainConfig] = None, mesh=None,
          ckpt_manager=None, ckpt_every: int = 0, start_step: int = 0,
          log_every: int = 0, watchdog: Optional[StragglerWatchdog] = None,
          opt_state=None, residuals=None):
    """Simple synchronous trainer used by the zoo, the train CLI and tests.

    ``opt_state`` / ``residuals`` seed the optimizer moments and the
    error-feedback residuals on resume (restored from a checkpoint);
    fresh state is initialized when omitted. Under a ``Placed`` mesh they
    and ``params`` are this rank's shards (and come back so); under a
    plain ``DeviceMesh`` whole trees are placed once here and all-gathered
    at the end. Checkpoints hold whole leaves either way. Returns
    (params, opt_state, losses)."""
    opt = AdamW(opt_cfg)
    compress = bool(train_cfg) and train_cfg.grad_compress == "ef_int8"
    lay = whole = None
    if mesh is not None:
        lay, whole = _layout(params, cfg, mesh)
    if whole:
        params, opt_state, residuals = _moved(place, lay, params, opt_state,
                                              residuals)
        mesh = lay
    if opt_state is None:
        opt_state = opt.init(params)
    if compress:
        step_fn = make_ef_train_step(cfg, opt, train_cfg, mesh)
        if residuals is None:
            residuals = init_residuals(params)
    else:
        step_fn = make_train_step(cfg, opt, train_cfg, mesh)
    losses = []
    for i, batch in enumerate(batches):
        step = start_step + i
        t0 = time.perf_counter()
        if compress:
            params, opt_state, residuals, l = step_fn(
                params, opt_state, residuals, batch)
        else:
            params, opt_state, l = step_fn(params, opt_state, batch)
        l = float(l)                     # syncs: dt is the step's wall
        dt = time.perf_counter() - t0
        if watchdog is not None:
            watchdog.observe(step, dt)
        losses.append(l)
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {l:.4f} ({dt*1e3:.0f} ms)")
        if ckpt_manager is not None and ckpt_every and \
                (step + 1) % ckpt_every == 0:
            saved = (params, opt_state, residuals if compress else None)
            if lay is not None:
                # whole leaves (the EF residuals' blocks are those of the
                # ranks that own them)
                saved = _moved(unplace, lay, *saved)
            state = {"params": saved[0], "opt_state": saved[1]}
            if compress:
                # EF residuals carry unsent gradient mass; dropping them
                # on restart re-introduces the compressor bias
                state["residuals"] = saved[2]
            ckpt_manager.save(step + 1, state)
    if whole:
        params, opt_state, _ = _moved(unplace, lay, params, opt_state)
    return params, opt_state, losses
