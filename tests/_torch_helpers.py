"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
config and param conversion from the JAX package to the port, and the
scale-relative comparison of the JAX kernel suite."""
import dataclasses

import jax
import numpy as np
import torch

from repro.data.tokens import DataConfig as JaxDataConfig
from repro.data.tokens import SyntheticLM as JaxSyntheticLM
from repro.models import init_params as jax_init_params

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


def jax_backed(monkeypatch, arch, *modules):
    """Launcher modules (the port's cure / plan / serve) fed the JAX
    run's params (``init_params``) and calibration batches
    (``SyntheticLM``) for the SMOKE config of ``arch``."""
    from repro.configs import get_smoke as jax_get_smoke
    jcfg = jax_get_smoke(arch)

    def init(seed, cfg, device):
        return port_params(jax_init_params(jax.random.PRNGKey(seed), jcfg),
                           device)

    class Data:
        def __init__(self, dc, device):
            self.ds = JaxSyntheticLM(JaxDataConfig(
                vocab_size=dc.vocab_size, seq_len=dc.seq_len,
                global_batch=dc.global_batch, seed=dc.seed))
            self.device = device

        def batch_at(self, i):
            return {k: torch.from_numpy(np.array(v)).long().to(self.device)
                    for k, v in self.ds.batch_at(i).items()}

    for mod in modules:
        monkeypatch.setattr(mod, "init_params", init)
        monkeypatch.setattr(mod, "SyntheticLM", Data)


def rel_err(y, yr) -> float:
    y = np.asarray(y, np.float32)
    yr = np.asarray(yr, np.float32)
    return float(np.abs(y - yr).max() / (np.abs(yr).max() + 1e-9))


def assert_close(y, yr, tol=2e-5):
    """Scale-relative max error below ``tol`` (2e-5 f32 by default)."""
    rel = rel_err(y, yr)
    assert rel < tol, f"max scaled error {rel} > {tol}"
