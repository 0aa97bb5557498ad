"""Calibration pass (paper §4.1/§4.2): one forward over the calibration set
collecting, per block,

  - the last-token hidden state entering/leaving every block (for
    angular-distance layer selection), and
  - the accumulated squared input activations of every CURing target weight
    (for WANDA importance): over all tokens, and for an ``experts.*``
    target (each held routed expert's weight) over the tokens routed to
    that expert, with each held expert's token count.

The accumulators stay on the device across batches; the only host
transfer is one copy of one flat buffer at the end.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA, MLP, MOE
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.model import (
    _embed, _positions, channel_input, channel_mix, iter_layer_params,
    mixer_input, mixer_output)
from repro_torch.models.moe import expert_act_sq
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class CalibStats:
    hidden: np.ndarray            # (L+1, n_samples, D) last-token states, f32
    # per-layer: name -> (m,) sum x^2; an ``experts.*`` target (E, m),
    # one row a held expert, over the tokens routed to it
    act_sq: List[Dict[str, np.ndarray]]
    n_tokens: int
    distances: np.ndarray = None  # filled by compress
    # per-layer (E,) tokens routed to each held expert, where the layer
    # has an ``experts.*`` target (else None)
    expert_tokens: List[Optional[np.ndarray]] = None


# target weight -> which normed input feeds it
_MIXER_TARGETS = {"wq", "wk", "wv", "w_z", "w_x", "w_B", "w_C", "w_dt"}
_MLP_TARGETS = {"w_gate", "w_up"}
# the shared expert's and each held routed expert's (one CUR target an
# expert) weights that read the channel mixer's input
_SHARED_TARGETS = {"shared." + t for t in _MLP_TARGETS}
_EXPERT_TARGETS = {"experts." + t for t in _MLP_TARGETS}


def _sq_sum(h: torch.Tensor) -> torch.Tensor:
    """Sum of squares over all tokens. h: (B, S, m) -> (m,) f32."""
    return torch.sum(h.float() ** 2, dim=(0, 1))


@torch.no_grad()
def _calib_step(params, cfg, batch):
    """Instrumented forward for one micro-batch (mirrors
    ``model.block_forward``). Returns (hs (L+1, B, D) last-token states,
    per-layer act_sq dicts, per-layer held experts' token counts or
    None), all on the device."""
    x = _embed(params, cfg, batch)
    positions = _positions(x)
    hs = [x[:, -1, :]]
    act_sq: List[Dict[str, torch.Tensor]] = []
    tokens: List[Optional[torch.Tensor]] = []
    for li, spec, p in iter_layer_params(params, cfg):
        acc: Dict[str, torch.Tensor] = {}
        h1 = mixer_input(x, p, cfg)
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
        x = x + mixer_output(a, p, cfg)
        n_routed = None
        if spec.mlp in (MLP, MOE):
            h2 = channel_input(x, p, cfg)
            for t in cfg.cur_targets:
                if (t in _MLP_TARGETS and t in p
                        or t in _SHARED_TARGETS and "shared" in p):
                    acc[t] = _sq_sum(h2)
            experts = [t for t in cfg.cur_targets if t in _EXPERT_TARGETS]
            if spec.mlp == MOE and experts:
                sq, n_routed = expert_act_sq(h2, p["router"], cfg)
                for t in experts:
                    acc[t] = sq
            x = channel_mix(x, p, spec, cfg)
        hs.append(x[:, -1, :])
        act_sq.append(acc)
        tokens.append(n_routed)
    return torch.stack(hs), act_sq, tokens


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
    tok_acc: List[Optional[torch.Tensor]] = [None] * cfg.n_layers
    n_tokens = 0
    for batch in batches:
        t0 = time.perf_counter()
        inp = batch["tokens"] if cfg.input_mode == "tokens" \
            else batch["embeds"]
        n_tokens += inp.shape[0] * inp.shape[1]
        hs, act_sq, routed = _calib_step(params, cfg, batch)
        hidden_chunks.append(hs)
        for li, acc in enumerate(act_sq):
            for t, sq in acc.items():
                prev = act_acc[li].get(t)
                act_acc[li][t] = sq if prev is None else prev + sq
        for li, n in enumerate(routed):
            if n is not None:
                prev = tok_acc[li]
                tok_acc[li] = n if prev is None else prev + n
        if timed:
            if inp.device.type == "cuda":
                torch.cuda.synchronize(inp.device)
            h_batch.observe(time.perf_counter() - t0)
    hidden = torch.cat(hidden_chunks, dim=1).float()
    parts = [hidden.reshape(-1)] + [
        acc[t].reshape(-1) for acc in act_acc for t in sorted(acc)] + [
        n for n in tok_acc if n is not None]
    flat = torch.cat(parts).cpu().numpy()          # the one host transfer
    out_hidden = flat[:hidden.numel()].reshape(tuple(hidden.shape))
    off = hidden.numel()

    def take(shape):
        nonlocal off
        n = int(np.prod(shape))
        out = flat[off:off + n].reshape(shape)
        off += n
        return out
    act_np: List[Dict[str, np.ndarray]] = [
        {t: take(tuple(acc[t].shape)) for t in sorted(acc)}
        for acc in act_acc]
    tok_np = [None if n is None else take(tuple(n.shape)) for n in tok_acc]
    h_routed = obs_metrics.histogram(
        "repro_calibrate_expert_tokens",
        "calibration tokens routed to each held expert, per MoE layer",
        buckets=obs_metrics.log_buckets(1.0, 1e7))
    for n in tok_np:
        for v in (n if n is not None else ()):
            h_routed.observe(float(v))
    c_time.inc(time.perf_counter() - t_pass)
    c_toks.inc(n_tokens)
    return CalibStats(hidden=out_hidden, act_sq=act_np, n_tokens=n_tokens,
                      expert_tokens=tok_np)
