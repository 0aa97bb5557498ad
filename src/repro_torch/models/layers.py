"""Shared low-level layers: norms, rotary embeddings, activations, and the
CUR-aware weight application used by every matmul of the model.

A "weight" in the param tree is either a plain tensor, a CUR dict made
by ``repro_torch.core.compress``:

    {"C": (m, r), "U0": (r, r), "dU": (r, r), "R": (r, n)}     # healing form
    {"CU": (m, r), "R": (r, n)}                                # folded form

or a PEFT adapter made by ``repro_torch.core.peft`` (``{"base": W, ...}``
with LoRA, MoRA or CURLoRA leaves). ``apply_w(x, w)`` dispatches on the
form, so compressed, adapted and dense layers share all model code.

Under a mesh ``apply_w(x, w, spec, mesh)`` takes this rank's shard of
``w`` (``repro_torch.dist.sharding.place``) and its spec, and runs the
Megatron layouts explicitly: a dim sharded over 'data' (FSDP) is
all-gathered just before use (:func:`gather_fsdp`; its backward
reduce-scatters), a column-parallel weight gives this rank's output
columns, and a row-parallel one takes this rank's input columns and
all-reduces its partial output over 'model'. A CUR dict takes its specs
per factor: a column-parallel ``{CU, R}`` runs ``(x @ CU) @ R_local``
(``cur_matmul`` on the card, dispatched as on one device: a folded
weight the kernel takes raises under autograd), a row-parallel one
all-reduces the rank-space ``(M, r)`` partial product before ``@ R``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col


# ---------------------------------------------------------------------------
# CUR-aware matmul
# ---------------------------------------------------------------------------

def is_cur(w) -> bool:
    return isinstance(w, dict) and ("C" in w or "CU" in w)


# The activation row count (flattened batch) below which a folded weight
# stays on the two-product chain: the JAX package's crossover, not yet
# re-measured on the H100.
CUR_KERNEL_MIN_M = 32


def use_cur_kernel(m: int, rk: int, n: int, M: Optional[int] = None,
                   on_cuda: bool = False) -> bool:
    """Gate for dispatching a folded CUR matmul to the fused ``cur_matmul``
    op. ``M`` is the activation row count (None: assumed large);
    ``on_cuda`` says whether the activation lies on a CUDA device. The
    shape thresholds are the JAX package's."""
    if M is not None and M < CUR_KERNEL_MIN_M:
        return False
    return (on_cuda and m >= 128 and n >= 128 and rk >= 16
            and m % 8 == 0 and n % 8 == 0)


def is_adapter(w) -> bool:
    return isinstance(w, dict) and "base" in w


def _mora_apply(x, M, n_out: int):
    """MoRA (Jiang et al. 2024) square-matrix adapter: compress input
    segments by summation, apply M (r x r), tile the output to n_out."""
    r = M.shape[0]
    m = x.shape[-1]
    xp = F.pad(x, (0, (-m) % r))
    xc = xp.reshape(xp.shape[:-1] + (-1, r)).sum(dim=-2)
    y = xc @ M.to(x.dtype)
    reps = -(-n_out // r)
    return y.repeat((1,) * (y.dim() - 1) + (reps,))[..., :n_out]


# the batch axes: a weight dim sharded over them is an FSDP dim
_BATCH_AXES = ("pod", "data")


def is_model(entry) -> bool:
    """Whether a spec entry shards its dim over 'model' (TP)."""
    return "model" in col.entry_axes(entry)


def weight_axes(spec):
    """(input-dim entry, output-dim entry) of a weight's spec: a dense
    weight's 2-entry spec, or a CUR dict's factor specs (``C`` / ``CU``
    give the input dim, ``R`` the output dim). An adapter or a
    replicated weight gives (None, None)."""
    if isinstance(spec, dict):
        left = spec.get("CU", spec.get("C"))
        right = spec.get("R")
        return (left[0] if left else None, right[-1] if right else None)
    if spec is None:
        return None, None
    return spec[-2], spec[-1]


def gather_fsdp(w, spec, mesh):
    """``w`` (a tensor or a dict of them) with every dim its spec shards
    over a batch axis all-gathered: the FSDP (ZeRO-3) gather, whose
    backward sums the data ranks' gradients and keeps this rank's
    block."""
    if isinstance(w, dict):
        return {k: gather_fsdp(v, spec.get(k) if isinstance(spec, dict)
                               else None, mesh) for k, v in w.items()}
    if w is None:
        return None
    for d, entry in enumerate(spec or ()):
        ax = tuple(a for a in col.entry_axes(entry) if a in _BATCH_AXES)
        if ax:
            w = col.all_gather(w, d, mesh, ax)
    return w


def to_input(h, local: bool, spec, mesh):
    """Activation ``h`` (this rank's columns over 'model' when ``local``,
    else whole) as the weight of ``spec`` takes it: this rank's columns
    for a row-parallel weight, the whole row otherwise."""
    want = is_model(weight_axes(spec)[0])
    if want and not local:
        return col.scatter(h, -1, mesh, "model")
    if local and not want:
        return col.gather(h, -1, mesh, "model")
    return h


def out_local(spec) -> bool:
    """Whether the weight of ``spec`` gives this rank's output columns."""
    return is_model(weight_axes(spec)[1])


def apply_w(x: torch.Tensor, w, spec=None, mesh=None) -> torch.Tensor:
    """x @ W for dense, CUR-factorized, or PEFT-adapted W.
    x: (..., m) -> (..., n). With a ``mesh`` (a DeviceMesh), ``w`` is this
    rank's shard placed per ``spec`` (see the module docstring): ``x`` is
    whole for a column-parallel or replicated weight and this rank's
    columns for a row-parallel one; the result is this rank's columns
    for a column-parallel weight (:func:`out_local`), whole otherwise."""
    if mesh is None:
        return _apply(x, w)
    w = gather_fsdp(w, spec, mesh)
    k_in, k_out = weight_axes(spec)
    if is_model(k_out):
        if is_cur(w) and _records(x, w) and not _kernel_form(x, w):
            # column-parallel CUR under autograd: the rank-space (M, r)
            # product is whole on every rank and feeds this rank's R
            # columns, so its gradient (and the left factors') is summed
            # over 'model'
            return col.copy_to(_left(x, w), mesh, "model") @ _right(x, w)
        # inference runs cur_matmul on the local R shard; a folded weight
        # the kernel takes raises under autograd, as on one device
        return _apply(col.copy_to(x, mesh, "model"), w)
    if not is_model(k_in):
        return _apply(x, w)
    if not is_cur(w):
        return col.reduce_from(x @ w, mesh, "model")
    # row-parallel CUR: sum the rank-space (M, r) partials, not (M, n)
    if "CU" in w:
        return col.reduce_from(x @ w["CU"], mesh, "model") @ w["R"]
    t = col.reduce_from(x @ w["C"].to(x.dtype), mesh, "model")
    t = t @ (w["U0"] + w["dU"]).to(x.dtype)
    return t @ w["R"].to(x.dtype)


def _records(x, w) -> bool:
    """Whether autograd records ``x @ w``: grad mode is on and ``x`` or a
    leaf of ``w`` requires a gradient."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in w.values()))


def _kernel_form(x, w) -> bool:
    """Whether ``_apply`` runs the folded CUR weight ``w`` on ``x``
    through ``cur_matmul``."""
    return "CU" in w and use_cur_kernel(
        w["CU"].shape[0], w["CU"].shape[1], w["R"].shape[1],
        math.prod(x.shape[:-1]), on_cuda=x.is_cuda)


def _left(x, w):
    """x @ CU, or (x @ C) @ (U0 + dU): a CUR weight's rank-space product
    (the chain's first part)."""
    if "CU" in w:
        return x @ w["CU"]
    t = x @ w["C"].to(x.dtype)
    return t @ (w["U0"] + w["dU"]).to(x.dtype)


def _right(x, w):
    """The R factor as the chain's second part takes it."""
    return w["R"] if "CU" in w else w["R"].to(x.dtype)


def _apply(x: torch.Tensor, w) -> torch.Tensor:
    if is_adapter(w):
        y = _apply(x, w["base"])
        if "lora_A" in w:                      # LoRA: + x A B
            y = y + (x @ w["lora_A"].to(x.dtype)) @ w["lora_B"].to(x.dtype)
        elif "mora" in w:                      # MoRA square adapter
            y = y + _mora_apply(x, w["mora"], y.shape[-1])
        elif "cC" in w:                        # CURLoRA: + x C U R (U trained)
            y = y + ((x @ w["cC"].to(x.dtype))
                     @ w["cU"].to(x.dtype)) @ w["cR"].to(x.dtype)
        return y
    if not is_cur(w):
        return x @ w
    if "CU" in w:
        cu, r = w["CU"], w["R"]
        if _kernel_form(x, w):
            from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
            return cur_matmul_op(x, cu.to(x.dtype), r.to(x.dtype))
        return (x @ cu) @ r
    u = (w["U0"] + w["dU"]).to(x.dtype)
    t = x @ w["C"].to(x.dtype)
    t = t @ u
    return t @ w["R"].to(x.dtype)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x, scale=None, eps: float = 1e-5):
    """f32 statistics, input-dtype data path: only the (..., 1) variance is
    f32, as in the JAX package."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = x * inv
    if scale is not None:
        y = y * scale.to(x.dtype)
    return y


def layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mu.to(x.dtype)) * inv
    if scale is not None:
        y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def norm(x, params: Optional[dict], cfg) -> torch.Tensor:
    """Config-dispatched norm. ``params`` may be None (non-parametric)."""
    scale = params.get("scale") if params else None
    if cfg.norm_type == "layernorm":
        return layer_norm(x, scale, None, cfg.norm_eps)
    return rms_norm(x, scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int. Split-half rotation."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions.float()[..., None] * inv              # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults."""
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]
