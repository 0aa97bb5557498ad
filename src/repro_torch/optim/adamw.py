"""AdamW with a cosine/warmup schedule, global-norm clipping, and optional
int8 row-quantized moments (8-bit-Adam-style), as in the JAX package's
``repro.optim.adamw``.

States have the JAX package's tree shape, ``{"step": int32 0-d, "moments":
...}`` with one moment dict per parameter and ``None`` for a frozen
(``None``) parameter, so a checkpoint of either package's state restores
in the other. The schedule, the bias corrections and the global norm are
float32 tensors, as JAX computes them, not Python doubles; ``torch.round``
rounds half to even like ``jnp.round``, so the int8 codes are JAX's.

The update is functional (new tensors, the inputs untouched), like the
JAX one; it runs under ``torch.no_grad``. On placed params (``mesh``, a
``repro_torch.dist.sharding.Placed``: each rank holds its shards, which
GSPMD does for JAX) every rank updates its own shards: the global norm
sums each leaf's squares over the axes the leaf is sharded on (a leaf
replicated over an axis counts once), and an int8 row scale over a
sharded last axis is the max over that axis's ranks, so the codes are
JAX's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.bridge import flatten_up_to, unflatten_as
from repro_torch.configs.base import OptimizerConfig
from repro_torch.dist import collectives as col


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def make_schedule(cfg: OptimizerConfig):
    """``lr_at(step)`` -> float32 0-d tensor (on the step's device)."""
    def lr_at(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "cosine":
            t = torch.clamp((step - cfg.warmup_steps)
                            / max(cfg.total_steps - cfg.warmup_steps, 1),
                            0, 1)
            decay = 0.5 * (1.0 + torch.cos(math.pi * t))
        elif cfg.schedule == "constant":
            decay = 1.0
        else:
            raise ValueError(cfg.schedule)
        return cfg.lr * warm * decay
    return lr_at


# ---------------------------------------------------------------------------
# int8 row-wise quantization for moment states
# ---------------------------------------------------------------------------

def _rowmax(t):
    return torch.amax(t, dim=-1, keepdim=True)


def sharded_rowmax(mesh, spec):
    """The row max (over the last dim, kept) of a leaf of ``spec`` whose
    last dim may be sharded: the local max, then the max over the ranks
    of that dim's axes (``_rowmax`` when it is whole)."""
    axes = col.entry_axes(spec[-1] if spec else None)
    if not axes:
        return _rowmax

    def rowmax(t):
        return col.all_reduce_max(_rowmax(t), mesh, axes)
    return rowmax


def _q8(x, block: int = 0, rowmax=_rowmax):
    """Row-wise (last-dim absmax) int8 quantization for the FIRST moment.
    Codes keep the param's shape; scales have shape x.shape[:-1].
    ``rowmax`` takes the row max (:func:`sharded_rowmax` on a shard)."""
    scale = rowmax(torch.abs(x))
    q = torch.round(x / torch.clamp(scale, min=1e-30) * 127.0)
    return q.to(torch.int8), scale[..., 0]


def _dq8(q, scale, shape=None):
    return q.to(torch.float32) * (scale[..., None] / 127.0)


def _q8_sqrt(v, rowmax=_rowmax):
    """Second-moment quantization in sqrt space (quadratic code): linear
    absmax codes flush small v entries to zero and m/sqrt(v) explodes.
    code = sqrt(v/vmax)*127."""
    scale = rowmax(v)                                      # vmax per row
    q = torch.round(torch.sqrt(v / torch.clamp(scale, min=1e-30)) * 127.0)
    return q.to(torch.int8), scale[..., 0]


def _dq8_sqrt(q, scale):
    c = q.to(torch.float32) / 127.0
    return (c * c) * scale[..., None]


def _sqrt_noise_floor(scale):
    """Half-bucket quantization noise in sqrt(v) units, added to the Adam
    denominator so quantized-to-zero v entries cannot blow up the step."""
    return torch.sqrt(torch.clamp(scale, min=0.0))[..., None] / 254.0


def q8_rowwise(x, rowmax=_rowmax):
    """Per-row absmax int8 quantization -> (codes, scales): the 8-bit
    format shared by the optimizer moments and the error-feedback
    gradient compression (``repro_torch.dist.compression``)."""
    return _q8(x.to(torch.float32), rowmax=rowmax)


def dq8_rowwise(q, scale):
    return _dq8(q, scale)


# ---------------------------------------------------------------------------
# state layout
# ---------------------------------------------------------------------------

# moment entries shaped exactly like the param
STATE_FULL_KEYS = ("m", "v", "m_q", "v_q")
# per-row absmax scales shaped param.shape[:-1]
STATE_SCALE_KEYS = ("m_s", "v_s")


def state_spec_from_param(param_entries, state_key: str):
    """Map a param's per-dim layout entries to those of one optimizer-state
    leaf (codes keep the layout, scales drop the quantization axis)."""
    entries = list(param_entries)
    if state_key in STATE_FULL_KEYS or state_key == "step":
        return entries
    if state_key in STATE_SCALE_KEYS:
        return entries[:-1]
    raise KeyError(f"unknown optimizer state key: {state_key}")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    cfg: OptimizerConfig

    def init(self, params):
        """Zero moments on each param's device (a ``meta`` tree gives the
        state's shapes without allocating it)."""
        def mk(p):
            if p is None:
                return None
            if self.cfg.quantized_state:
                def z8():
                    return torch.zeros(p.shape, dtype=torch.int8,
                                       device=p.device)

                def zs():
                    return torch.zeros(p.shape[:-1], dtype=torch.float32,
                                       device=p.device)
                return {"m_q": z8(), "m_s": zs(), "v_q": z8(), "v_s": zs()}
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for k in ("m", "v")}
        flat = flatten_up_to(params, params)
        device = next((p.device for p in flat if p is not None), "cpu")
        moments = unflatten_as(params, [mk(p) for p in flat])
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "moments": moments}

    @torch.no_grad()
    def update(self, params, grads, state, mesh=None):
        """One step. ``mesh``: a ``Placed`` of the params when they (and
        ``grads`` and ``state``) are this rank's shards."""
        cfg = self.cfg
        step = state["step"]
        lr = make_schedule(cfg)(step)
        flat_p = flatten_up_to(params, params)
        flat_g = flatten_up_to(params, grads)
        flat_m = flatten_up_to(params, state["moments"])
        flat_s = (flatten_up_to(params, mesh.specs) if mesh is not None
                  else [None] * len(flat_p))

        # global-norm clip over the live leaves, summed in leaf order
        if mesh is None:
            live = [g for p, g in zip(flat_p, flat_g) if p is not None]
            sq = torch.as_tensor(
                sum(torch.sum(torch.square(g.to(torch.float32)))
                    for g in live), dtype=torch.float32)
        else:
            sq = _sharded_sq_sum(flat_p, flat_g, flat_s, mesh.mesh)
        gnorm = torch.sqrt(sq)
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)

        stepf = step.to(torch.float32) + 1
        bc1 = 1.0 - torch.pow(cfg.b1, stepf)
        bc2 = 1.0 - torch.pow(cfg.b2, stepf)

        def upd(p, g, mom, spec):
            if p is None:
                return None, None
            rowmax = (_rowmax if mesh is None
                      else sharded_rowmax(mesh.mesh, spec))
            g = g.to(torch.float32) * clip
            noise = 0.0
            if cfg.quantized_state:
                m = _dq8(mom["m_q"], mom["m_s"], p.shape)
                v = _dq8_sqrt(mom["v_q"], mom["v_s"])
            else:
                m, v = mom["m"], mom["v"]
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            if cfg.quantized_state:
                noise = _sqrt_noise_floor(rowmax(vh)[..., 0])
            delta = mh / (torch.sqrt(vh) + noise + cfg.eps)
            if p.dim() >= 2:                     # decoupled weight decay
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
            if cfg.quantized_state:
                mq, ms = _q8(m, cfg.state_block, rowmax)
                vq, vs = _q8_sqrt(v, rowmax)
                return new_p, {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
            return new_p, {"m": m, "v": v}

        out = [upd(*a) for a in zip(flat_p, flat_g, flat_m, flat_s)]
        new_params = unflatten_as(params, [o[0] for o in out])
        new_moments = unflatten_as(params, [o[1] for o in out])
        return new_params, {"step": step + 1, "moments": new_moments}


def _sharded_sq_sum(flat_p, flat_g, flat_s, mesh):
    """The sum of squares of every live gradient leaf, each summed over
    the axes its spec shards it on: the leaves are grouped by those axes,
    and each group's sum (in leaf order) is all-reduced over them once."""
    groups = {}
    for p, g, spec in zip(flat_p, flat_g, flat_s):
        if p is None:
            continue
        groups.setdefault(col.spec_axes(spec), []).append(
            torch.sum(torch.square(g.to(torch.float32))))
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(groups.values()))[0].device)
    for axes, parts in groups.items():
        part = torch.stack(parts).sum()
        total = total + (col.all_reduce(part, mesh, axes) if axes else part)
    return total
