"""Training loop: the train step with optional microbatch gradient
accumulation, error-feedback int8 gradient compression, a straggler
watchdog, and checkpoint-manager hooks (``repro.train.train_loop`` in the
JAX package).

The step is eager PyTorch (JAX jits it): gradients come from
``torch.autograd.grad`` over detached aliases of the parameters
(``repro_torch.core.heal.value_and_grad``), and the update is AdamW's
functional one. Microbatches are a Python loop whose loss and gradients
are the means over the microbatches, as JAX's ``lax.scan`` gives them.

Under a ``mesh`` (JAX: GSPMD under ``jit``) every rank passes the same
global batch and holds the same replicated params and optimizer state.
The step takes this rank's rows per ``batch_pspecs`` (over the 'pod' /
'data' axes), runs the loss on them with the 'model' axis's submesh (the
MoE bodies' collectives), and averages the gradients over the batch axes
in one f32 all-reduce, or through ``compressed_psum`` under error
feedback (each rank then keeps its own residuals). Every rank applies the
same AdamW update. The loss is the mean of the ranks' row means, which is
the global mean for an unmasked batch split in equal parts.
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
from repro_torch.dist.collectives import all_reduce, axes_size, dp_axes
from repro_torch.dist.compression import (
    ef_compress_grads, ef_psum_grads, init_residuals)
from repro_torch.dist.sharding import shard_batch
from repro_torch.models.model import loss_fn
from repro_torch.optim.adamw import AdamW


def make_train_step(cfg: ModelConfig, opt: AdamW,
                    train_cfg: Optional[TrainConfig] = None, mesh=None,
                    loss=loss_fn):
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss).

    With train_cfg.microbatch > 0 the (rank's) batch is split into
    micro-batches whose gradients are averaged: activation memory scales
    with the micro-batch."""
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
    ``mesh`` the gradients are reduced over the batch axes through
    ``compressed_psum``."""
    return _make_step(cfg, opt, train_cfg, mesh, loss, compress=True)


def make_grads_fn(cfg: ModelConfig, train_cfg: Optional[TrainConfig] = None,
                  mesh=None, loss=loss_fn):
    """(params, batch) -> (loss, grads) of the step without compression:
    under a ``mesh``, the mean over the batch axes (the gradient every
    rank's update applies)."""
    local = _local_grads_fn(cfg, train_cfg, mesh, loss)
    if mesh is None:
        return local
    dp = dp_axes(mesh)

    def grads_of(params, batch):
        l, grads = local(params, batch)
        return l, _mean_grads(params, grads, mesh, dp)

    return grads_of


def _local_grads_fn(cfg, train_cfg, mesh, loss):
    """(params, batch) -> (loss, this rank's gradients). Under a mesh the
    loss runs on this rank's rows with the 'model' submesh, and is the
    mean over the batch axes."""
    micro = train_cfg.microbatch if train_cfg else 0
    if mesh is None:
        return _make_grads_fn(lambda p, b: loss(p, cfg, b), micro)
    inner = mesh["model"] if "model" in mesh.mesh_dim_names else None
    grads_of = _make_grads_fn(lambda p, b: loss(p, cfg, b, inner), micro)
    dp = dp_axes(mesh)

    def local(params, batch):
        l, grads = grads_of(params, shard_batch(batch, cfg, mesh))
        l = all_reduce(l.to(torch.float32).clone(), mesh, dp)
        return l / axes_size(mesh, dp), grads

    return local


def _mean_grads(params, grads, mesh, dp):
    """The mean over the batch axes of every rank's gradients, in one f32
    all-reduce of the concatenated leaves."""
    flat = flatten_up_to(params, grads)
    live = [g for g in flat if g is not None]
    buf = torch.cat([g.to(torch.float32).reshape(-1) for g in live])
    all_reduce(buf, mesh, dp)
    buf /= axes_size(mesh, dp)
    parts = iter(buf.split([g.numel() for g in live]))
    return unflatten_as(params, [
        None if g is None else next(parts).view(g.shape).to(g.dtype)
        for g in flat])


def _make_step(cfg, opt, train_cfg, mesh, loss, *, compress: bool):
    """One factory behind both steps: only the EF hook and the threaded
    residuals differ."""
    if compress:
        grads_of = _local_grads_fn(cfg, train_cfg, mesh, loss)

        def step(params, opt_state, residuals, batch):
            l, grads = grads_of(params, batch)
            if mesh is None:
                grads, residuals = ef_compress_grads(grads, residuals)
            else:
                grads, residuals = ef_psum_grads(grads, residuals, mesh,
                                                 dp_axes(mesh))
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, residuals, l
    else:
        grads_of = make_grads_fn(cfg, train_cfg, mesh, loss)

        def step(params, opt_state, batch):
            l, grads = grads_of(params, batch)
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, l

    return step


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
    fresh state is initialized when omitted. Returns (params, opt_state,
    losses)."""
    opt = AdamW(opt_cfg)
    if opt_state is None:
        opt_state = opt.init(params)
    compress = bool(train_cfg) and train_cfg.grad_compress == "ef_int8"
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
            state = {"params": params, "opt_state": opt_state}
            if compress:
                # EF residuals carry unsent gradient mass; dropping them
                # on restart re-introduces the compressor bias
                state["residuals"] = residuals
            ckpt_manager.save(step + 1, state)
    return params, opt_state, losses
