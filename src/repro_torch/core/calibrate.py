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
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA, MLP, MOE
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.layers import norm
from repro_torch.models.mlp import mlp_forward
from repro_torch.models.model import _embed, _positions, iter_layer_params
from repro_torch.models.moe import moe_forward
from repro_torch.obs import metrics as obs_metrics


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
        if spec.mixer in (ATTN, ATTN_LOCAL):
            win = cfg.window if spec.mixer == ATTN_LOCAL else 0
            a = attn.attn_forward(h1, p, cfg, positions, window=win)
        elif spec.mixer == MAMBA:
            a = mb.mamba_forward(h1, p, cfg)
        else:
            raise ValueError(spec.mixer)
        x = x + a
        if spec.mlp in (MLP, MOE):
            h2 = norm(x, p.get("norm2"), cfg)
            for t in cfg.cur_targets:
                if t in _MLP_TARGETS and t in p:
                    acc[t] = _sq_sum(h2)
            if spec.mlp == MLP:
                x = x + mlp_forward(h2, p, cfg)
            else:
                x = x + moe_forward(h2, p, cfg)
        hs.append(x[:, -1, :])
        act_sq.append(acc)
    return torch.stack(hs), act_sq


def calibrate(params, cfg, batches) -> CalibStats:
    """batches: list of batch dicts (each one calibration micro-batch) whose
    tensors lie on the params' device."""
    # default-registry timings (NULL no-ops unless obs is enabled). A host
    # clock around an enqueue times nothing on CUDA, so with obs on each
    # batch's observation ends in a device sync; with obs off the pass
    # has no sync before its one host transfer.
    timed = obs_metrics.enabled()
    h_batch = obs_metrics.histogram(
        "repro_compress_calibrate_batch_s",
        "per-micro-batch calibration forward (s); first = first use of "
        "each kernel")
    c_time = obs_metrics.counter(
        "repro_compress_calibrate_time_s_total",
        "total calibration pass seconds")
    c_toks = obs_metrics.counter(
        "repro_compress_calibrate_tokens_total", "calibration tokens")
    t_pass = time.perf_counter()
    hidden_chunks = []
    act_acc: List[Dict[str, torch.Tensor]] = [
        dict() for _ in range(cfg.n_layers)]
    n_tokens = 0
    for batch in batches:
        t0 = time.perf_counter()
        inp = batch["tokens"] if cfg.input_mode == "tokens" \
            else batch["embeds"]
        n_tokens += inp.shape[0] * inp.shape[1]
        hs, act_sq = _calib_step(params, cfg, batch)
        hidden_chunks.append(hs)
        for li, acc in enumerate(act_sq):
            for t, sq in acc.items():
                prev = act_acc[li].get(t)
                act_acc[li][t] = sq if prev is None else prev + sq
        if timed:
            if inp.device.type == "cuda":
                torch.cuda.synchronize(inp.device)
            h_batch.observe(time.perf_counter() - t0)
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
    c_time.inc(time.perf_counter() - t_pass)
    c_toks.inc(n_tokens)
    return CalibStats(hidden=out_hidden, act_sq=act_np, n_tokens=n_tokens)
