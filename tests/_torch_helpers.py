"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
config and param conversion from the JAX package to the port, and the
scale-relative comparison of the JAX kernel suite."""
import dataclasses

import jax
import numpy as np

from repro_torch import bridge
from repro_torch.configs import base as tbase


def port_cfg(jcfg):
    """The port's ModelConfig with every field of the JAX one."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jcfg)}
    kw["groups"] = tuple(
        (tuple(tbase.BlockSpec(s.mixer, s.mlp) for s in pat), reps)
        for pat, reps in jcfg.groups)
    return tbase.ModelConfig(**kw)


def port_params(jparams, device="cpu"):
    return bridge.to_torch(jax.device_get(jparams), device)


def rel_err(y, yr) -> float:
    y = np.asarray(y, np.float32)
    yr = np.asarray(yr, np.float32)
    return float(np.abs(y - yr).max() / (np.abs(yr).max() + 1e-9))


def assert_close(y, yr, tol=2e-5):
    """Scale-relative max error below ``tol`` (2e-5 f32 by default)."""
    rel = rel_err(y, yr)
    assert rel < tol, f"max scaled error {rel} > {tol}"
