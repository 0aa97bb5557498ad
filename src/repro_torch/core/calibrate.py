"""Calibration pass (paper §4.1/§4.2): one forward over the calibration set
collecting, per block,

  - the last-token hidden state entering/leaving every block (for
    angular-distance layer selection), and
  - the accumulated squared input activations of every CURing target weight
    (for WANDA importance).

Both accumulators stay on the device across batches; the only host
transfer is one copy of one flat buffer at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MLP
from repro_torch.models import attention as attn
from repro_torch.models.layers import norm
from repro_torch.models.mlp import mlp_forward
from repro_torch.models.model import (
    _embed, _not_ported, _positions, iter_layer_params)


@dataclasses.dataclass
class CalibStats:
    hidden: np.ndarray            # (L+1, n_samples, D) last-token states, f32
    act_sq: List[Dict[str, np.ndarray]]   # per-layer: name -> (m,) sum x^2
    n_tokens: int
    distances: np.ndarray = None  # filled by compress


# target weight -> which normed input feeds it
_MIXER_TARGETS = {"wq", "wk", "wv", "w_z", "w_x", "w_B", "w_C", "w_dt"}
_MLP_TARGETS = {"w_gate", "w_up"}


def _sq_sum(h: torch.Tensor) -> torch.Tensor:
    """Sum of squares over all tokens. h: (B, S, m) -> (m,) f32."""
    return torch.sum(h.float() ** 2, dim=(0, 1))


@torch.no_grad()
def _calib_step(params, cfg, batch):
    """Instrumented forward for one micro-batch (mirrors
    ``model.block_forward``). Returns (hs (L+1, B, D) last-token states,
    per-layer act_sq dicts), all on the device."""
    x = _embed(params, cfg, batch)
    positions = _positions(x)
    hs = [x[:, -1, :]]
    act_sq: List[Dict[str, torch.Tensor]] = []
    for li, spec, p in iter_layer_params(params, cfg):
        acc: Dict[str, torch.Tensor] = {}
        h1 = norm(x, p.get("norm1"), cfg)
        for t in cfg.cur_targets:
            if t in _MIXER_TARGETS and t in p:
                acc[t] = _sq_sum(h1)
        if spec.mixer not in (ATTN, ATTN_LOCAL):
            raise _not_ported(spec.mixer)
        win = cfg.window if spec.mixer == ATTN_LOCAL else 0
        x = x + attn.attn_forward(h1, p, cfg, positions, window=win)
        if spec.mlp != MLP:
            raise _not_ported(spec.mlp)
        h2 = norm(x, p.get("norm2"), cfg)
        for t in cfg.cur_targets:
            if t in _MLP_TARGETS and t in p:
                acc[t] = _sq_sum(h2)
        x = x + mlp_forward(h2, p, cfg)
        hs.append(x[:, -1, :])
        act_sq.append(acc)
    return torch.stack(hs), act_sq


def calibrate(params, cfg, batches) -> CalibStats:
    """batches: list of batch dicts (each one calibration micro-batch) whose
    tensors lie on the params' device."""
    hidden_chunks = []
    act_acc: List[Dict[str, torch.Tensor]] = [
        dict() for _ in range(cfg.n_layers)]
    n_tokens = 0
    for batch in batches:
        shape = (batch["tokens"] if cfg.input_mode == "tokens"
                 else batch["embeds"]).shape
        n_tokens += shape[0] * shape[1]
        hs, act_sq = _calib_step(params, cfg, batch)
        hidden_chunks.append(hs)
        for li, acc in enumerate(act_sq):
            for t, sq in acc.items():
                prev = act_acc[li].get(t)
                act_acc[li][t] = sq if prev is None else prev + sq
    hidden = torch.cat(hidden_chunks, dim=1).float()
    parts = [hidden.reshape(-1)] + [
        acc[t] for acc in act_acc for t in sorted(acc)]
    flat = torch.cat(parts).cpu().numpy()          # the one host transfer
    out_hidden = flat[:hidden.numel()].reshape(tuple(hidden.shape))
    off = hidden.numel()
    act_np: List[Dict[str, np.ndarray]] = []
    for acc in act_acc:
        d = {}
        for t in sorted(acc):
            n = acc[t].numel()
            d[t] = flat[off:off + n]
            off += n
        act_np.append(d)
    return CalibStats(hidden=out_hidden, act_sq=act_np, n_tokens=n_tokens)
