"""What every cell shares: the checkout's paths and cache directories, the
files found by name, the model configuration a config file describes,
and the check that nothing of JAX or of the JAX package is loaded.

Nothing here imports ``torch`` or the program at import time: ``run.py``
sets the environment first.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]        # perfbench/
ROOT = BENCH.parent                                # the checkout
BUILD = ROOT / "build"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_env() -> None:
    """Fixed cache directories inside the checkout (the program builds its
    kernels under ``build/kernels`` itself), no JAX through a library,
    and the program's sources on the path."""
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json``."""
    path = BENCH / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def forbidden_loaded() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package
    (compared whole: ``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def merged(spec: dict, smoke: bool) -> dict:
    """A config file's dict, with its ``smoke`` overrides (CPU tests)
    merged in when asked."""
    out = {k: v for k, v in spec.items() if k != "smoke"}
    if smoke:
        for k, v in spec.get("smoke", {}).items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = dict(out[k], **v)
            else:
                out[k] = v
    return out


def model_config(spec: dict):
    """The program's ``ModelConfig`` for a config file's (merged) dict."""
    from repro_torch.configs.base import (
        ATTN, ATTN_LOCAL, MLP, MOE, BlockSpec, ModelConfig)
    E = spec.get("num_local_experts", 0)
    win = spec.get("sliding_window") or 0
    block = BlockSpec(ATTN_LOCAL if win else ATTN, MOE if E else MLP)
    L = spec["num_hidden_layers"]
    kw = dict(
        name=spec["name"], d_model=spec["hidden_size"], n_layers=L,
        n_heads=spec["num_attention_heads"],
        n_kv_heads=spec["num_key_value_heads"], head_dim=spec["head_dim"],
        window=win, rope_theta=spec["rope_theta"],
        d_ff=spec["intermediate_size"], vocab_size=spec["vocab_size"],
        norm_eps=spec["rms_norm_eps"],
        tie_embeddings=spec["tie_word_embeddings"],
        groups=(((block,), L),), scan_layers=False, remat=False,
        dtype=spec["torch_dtype"])
    if E:
        kw.update(n_experts=E, n_experts_per_tok=spec["num_experts_per_tok"],
                  moe_d_ff=spec["intermediate_size"], moe_impl="dense")
    return ModelConfig(**kw)


def cur_targets(spec: dict) -> tuple:
    """The CUR targets the program compresses in this model: its default
    targets that are 2-D weights (a MoE layer's expert stacks are not)."""
    from repro_torch.configs.base import ModelConfig
    names = ModelConfig.__dataclass_fields__["cur_targets"].default
    if spec.get("num_local_experts"):
        return tuple(t for t in names if t != "w_gate")
    return tuple(names)
