"""Config registry of the port: ``get_config(name)`` / ``get_smoke(name)``.

Only the configurations the port runs so far are registered. Unlike the
JAX package's ``ARCHS`` (which leaves the paper's own model out of its CLI
choices), ``llama3.1-8b`` is a first-class entry here: it is the model the
port's main path runs at full width.
"""
from repro_torch.configs import llama31_8b, olmo_1b
from repro_torch.configs.base import (
    ATTN, ATTN_LOCAL, MAMBA, MLP, MOE, BlockSpec, CURConfig, ModelConfig,
    OptimizerConfig, TrainConfig)

_MODULES = {
    "llama3.1-8b": llama31_8b,
    "olmo-1b": olmo_1b,
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE


def get_repro() -> ModelConfig:
    """The CPU-scale llama-family model used for quality experiments."""
    return llama31_8b.REPRO


__all__ = ["ARCHS", "ATTN", "ATTN_LOCAL", "MAMBA", "MLP", "MOE", "BlockSpec",
           "CURConfig", "ModelConfig", "OptimizerConfig", "TrainConfig",
           "get_config", "get_repro", "get_smoke"]
