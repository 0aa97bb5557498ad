"""Config registry of the port: ``get_config(name)`` / ``get_smoke(name)``.

Every configuration of the JAX package is registered. Unlike the JAX
package's ``ARCHS`` (which leaves the paper's own model out of its CLI
choices), ``llama3.1-8b`` is a first-class entry here: it is the model the
port's main path runs at full width. ``ARCHS`` stays the JAX package's
mirror; ``PORT_ARCHS`` holds the models only the port runs
(``k-exaone-236b-a23b``), and ``get_config`` / ``get_smoke`` resolve both.
"""
from repro_torch.configs import (
    deepseek_67b,
    deepseek_coder_33b,
    gemma3_1b,
    jamba_v0_1_52b,
    k_exaone_236b,
    kimi_k2_1t_a32b,
    llama31_8b,
    mamba2_1_3b,
    mixtral_8x22b,
    musicgen_medium,
    olmo_1b,
    pixtral_12b,
)
from repro_torch.configs.base import (
    ATTN, ATTN_LOCAL, MAMBA, MLP, MOE, SHAPES, BlockSpec, CURConfig,
    ModelConfig, OptimizerConfig, ShapeConfig, TrainConfig,
    shape_applicable)

_MODULES = {
    "llama3.1-8b": llama31_8b,
    "olmo-1b": olmo_1b,
    "deepseek-67b": deepseek_67b,
    "gemma3-1b": gemma3_1b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "musicgen-medium": musicgen_medium,
    "mamba2-1.3b": mamba2_1_3b,
    "mixtral-8x22b": mixtral_8x22b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "pixtral-12b": pixtral_12b,
    "jamba-v0.1-52b": jamba_v0_1_52b,
}

ARCHS = tuple(_MODULES)

_PORT_MODULES = {
    "k-exaone-236b-a23b": k_exaone_236b,
}

PORT_ARCHS = tuple(_PORT_MODULES)
_ALL = {**_MODULES, **_PORT_MODULES}


def get_config(name: str) -> ModelConfig:
    return _ALL[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _ALL[name].SMOKE


def get_repro() -> ModelConfig:
    """The CPU-scale llama-family model used for quality experiments."""
    return llama31_8b.REPRO


__all__ = ["ARCHS", "ATTN", "ATTN_LOCAL", "MAMBA", "MLP", "MOE", "PORT_ARCHS",
           "SHAPES",
           "BlockSpec", "CURConfig", "ModelConfig", "OptimizerConfig",
           "ShapeConfig", "TrainConfig", "get_config", "get_repro",
           "get_smoke", "shape_applicable"]
