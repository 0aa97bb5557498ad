"""Train-once model zoo for the small-scale quality experiments
(``repro.zoo`` in the JAX package).

The paper's quality results (Fig. 4-7, Tables 4-6) need a *trained*
model: compression error on random weights is meaningless (they are full
rank). ``get_trained_repro()`` trains the llama-family repro model on the
synthetic corpus and caches it through the CheckpointManager, so later
runs share one artifact. The cache is the port's own (``ZOO_DIR``): the
port initialises from a ``torch.Generator`` and samples its corpus on the
device, so its model differs from the JAX package's for the same seed.
"""
from __future__ import annotations

import os

from repro_torch import resolve_device
from repro_torch.configs import get_repro
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.tokens import DataConfig, SyntheticLM
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.models import init_params
from repro_torch.train.train_loop import train

ZOO_DIR = os.path.join("results", "zoo_torch")
SEQ_LEN = 256
BATCH = 16


def data_config(cfg, seed: int = 0) -> DataConfig:
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                      global_batch=BATCH, seed=seed)


def eval_batches(cfg, n: int = 4, seed: int = 10_000, device=None):
    ds = SyntheticLM(data_config(cfg, seed=0), device)
    return [ds.batch_at(seed + i) for i in range(n)]


def get_trained_repro(steps: int = 300, quick: bool = False, device=None,
                      zoo_dir: str = ZOO_DIR):
    """Returns (params, cfg) on ``device``. Trains and caches under
    ``zoo_dir`` on the first call; later calls restore."""
    device = resolve_device(device)
    cfg = get_repro()
    if quick:
        steps = min(steps, 150)
    mgr = CheckpointManager(os.path.join(zoo_dir, f"{cfg.name}-s{steps}"),
                            keep_n=1)
    params = init_params(0, cfg, device)
    got = mgr.latest_valid_step()
    if got is not None:
        _, state = mgr.restore({"params": params}, device=device, step=got)
        return state["params"], cfg
    ds = SyntheticLM(data_config(cfg), device)
    params, _, _ = train(
        params, cfg,
        OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=steps),
        (ds.batch_at(i) for i in range(steps)), log_every=50)
    mgr.save(steps, {"params": params})
    return params, cfg
