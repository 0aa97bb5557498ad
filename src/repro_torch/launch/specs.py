"""Shape stand-ins for every model input, parameter and cache
(``repro.launch.specs`` in the JAX package, whose ``ShapeDtypeStruct``s
these are): ``meta`` tensors, which carry a shape and a dtype and hold no
memory, so a 1T-parameter config's tree is built without drawing a
number.

Also: structural CUR transformation of a parameter *shape* tree — the
paper's compression applied at full scale (every eligible weight in every
layer becomes C/U0/dU/R stand-ins with Eq.-2 ranks), so the compressed
model's layout and sizes are known without real weights.
"""
from __future__ import annotations

import torch

from repro_torch.bridge import flatten_up_to
from repro_torch.configs.base import CURConfig, ModelConfig, ShapeConfig
from repro_torch.core.cur import rank_for
from repro_torch.models.model import init_cache, init_params, torch_dtype


def S(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` (``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model inputs for a train/prefill step: tokens or stub embeddings."""
    B, L = shape.global_batch, shape.seq_len
    batch = {"labels": S((B, L), torch.int32)}
    if cfg.input_mode == "tokens":
        batch["tokens"] = S((B, L), torch.int32)
    else:
        batch["embeds"] = S((B, L, cfg.d_model), torch_dtype(cfg.dtype))
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(batch, pos) for one decode step with a seq_len-deep cache."""
    B = shape.global_batch
    if cfg.input_mode == "tokens":
        batch = {"tokens": S((B, 1), torch.int32)}
    else:
        batch = {"embeds": S((B, 1, cfg.d_model), torch_dtype(cfg.dtype))}
    return batch, S((B, 1), torch.int32)


def param_specs(cfg: ModelConfig):
    """Parameter stand-ins (``init_params`` on the meta device)."""
    return init_params(0, cfg, "meta")


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return init_cache(cfg, shape.global_batch, shape.seq_len, "meta")


# ---------------------------------------------------------------------------
# paged serving (repro_torch.serving) decode-shape stand-ins
# ---------------------------------------------------------------------------

def paged_config_for(shape: ShapeConfig, block_size: int = 128):
    """PagedConfig sized so ``global_batch`` sequences of ``seq_len``
    tokens fit exactly (the worst-case residency)."""
    from repro_torch.serving.paged_cache import PagedConfig
    maxb = -(-shape.seq_len // block_size)
    return PagedConfig(block_size=block_size,
                       n_blocks=shape.global_batch * maxb,
                       max_blocks_per_seq=maxb)


def paged_cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                      block_size: int = 128):
    """Stand-ins for the paged k/v pool at a decode shape, and its
    PagedConfig."""
    from repro_torch.serving.paged_cache import init_paged_cache
    pc = paged_config_for(shape, block_size)
    return init_paged_cache(cfg, pc, "meta"), pc


def paged_decode_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                             pc=None, block_size: int = 128):
    """(tokens, table, ctx_len, active) for one paged decode step. Pass
    the PagedConfig returned by :func:`paged_cache_specs` so the table
    width always matches the pool layout."""
    if pc is None:
        pc = paged_config_for(shape, block_size)
    B = shape.global_batch
    return (S((B, 1), torch.int32),
            S((B, pc.max_blocks_per_seq), torch.int32),
            S((B,), torch.int32), S((B,), torch.bool))


# ---------------------------------------------------------------------------
# structural CUR
# ---------------------------------------------------------------------------

def _cur_struct(leaf, r_max: int) -> dict:
    """Dense weight stand-in (..., m, n) -> CUR dict of stand-ins."""
    *lead, m, n = leaf.shape
    r = rank_for(m, n, r_max)
    lead = tuple(lead)
    return {
        "C": S(lead + (m, r), leaf.dtype),
        "U0": S(lead + (r, r), torch.float32),
        "dU": S(lead + (r, r), torch.float32),
        "R": S(lead + (r, n), leaf.dtype),
    }


def structural_cur(params, cfg: ModelConfig, cur_cfg: CURConfig):
    """Replace every CUR-target weight (all layers) with CUR stand-ins.
    Group stacking is preserved (uniform ranks). Returns the new params
    tree (stand-ins or tensors untouched elsewhere)."""
    new = {k: v for k, v in params.items() if k != "groups"}
    new["groups"] = []
    for gi, (pattern, reps) in enumerate(cfg.groups):
        group = []
        for pi, spec in enumerate(pattern):
            block = dict(params["groups"][gi][pi])
            for t in cfg.cur_targets:
                if t not in block:
                    continue
                leaf = block[t]
                if not hasattr(leaf, "shape"):
                    continue
                m, n = leaf.shape[-2], leaf.shape[-1]
                r = rank_for(m, n, cur_cfg.r_max)
                if m * r + r * r + r * n >= m * n:
                    continue  # Eq. 2: no saving, keep dense
                block[t] = _cur_struct(leaf, cur_cfg.r_max)
            group.append(block)
        new["groups"].append(group)
    return new


def fold_cur_struct(params):
    """Stand-in analogue of ``core.compress.fold_cur``: every healing-form
    CUR dict {C, U0, dU, R} becomes the folded serving form {CU, R}
    (C @ (U0 + dU) collapses to one (m, r) factor)."""
    if isinstance(params, dict):
        if set(params) == {"C", "U0", "dU", "R"}:
            C = params["C"]
            return {"CU": S(C.shape, C.dtype), "R": params["R"]}
        return {k: fold_cur_struct(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(fold_cur_struct(v) for v in params)
    return params


def count_struct_params(tree) -> int:
    return sum(int(leaf.numel()) for leaf in flatten_up_to(tree, tree)
               if hasattr(leaf, "shape"))
