"""Training entry point (``repro.launch.train`` in the JAX package), on one
device: checkpoint-managed auto-resume, the straggler watchdog,
deterministic skip-ahead data, optional error-feedback int8 gradients.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --steps 50 --ckpt-dir results/run1 [--resume] --device cpu

Checkpoints are the JAX package's format: one written by either package's
train CLI resumes in the other's (the same arch and ``--smoke``).
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

import torch

from repro_torch import resolve_device
from repro_torch.bridge import tree_map
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.tokens import DataConfig, SyntheticLM
from repro_torch.dist.checkpoint import (
    CheckpointManager, TensorSpec, tree_flatten)
from repro_torch.dist.compression import init_residuals
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_loop import StragglerWatchdog, train


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU scale)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "ef_int8"],
                    help="error-feedback int8 gradient compression")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def _spec(tree):
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def run(args):
    """Train as the CLI does. Returns a namespace with ``params``,
    ``opt_state``, ``losses``, ``start`` (the resumed step) and
    ``watchdog`` (its ``_times`` are the steps' wall seconds)."""
    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} needs the embeddings stub; use the "
                         f"smoke tests for this arch")
    params = init_params(0, cfg, device)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    compress = args.grad_compress == "ef_int8"
    start = 0
    opt_state = residuals = None
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_n=3)
        step = mgr.latest_valid_step() if args.resume else None
        if step is not None:
            # templates only supply tree structure + leaf shapes: built
            # from meta tensors as TensorSpecs (no moment/residual memory)
            meta = tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device="meta"), params)
            base = {"params": _spec(meta),
                    "opt_state": _spec(AdamW(opt_cfg).init(meta))}
            n_base = len(tree_flatten(base))
            # checkpoints written with --grad-compress carry extra EF
            # residual leaves; pick the template matching what's on disk
            # so toggling the flag between runs still resumes
            ckpt_has_res = mgr.leaf_count(step) > n_base
            template = (dict(base, residuals=_spec(init_residuals(meta)))
                        if ckpt_has_res else base)
            start, state = mgr.restore(template, device=device, step=step)
            params = state["params"]
            opt_state = state["opt_state"]       # resume Adam moments + step
            if compress and ckpt_has_res:
                residuals = state["residuals"]   # resume EF residuals
            elif compress:
                print("note: checkpoint has no EF residuals "
                      "(written without --grad-compress); starting fresh")
            elif ckpt_has_res:
                print("note: checkpoint carries EF residuals but "
                      "--grad-compress is off; discarding them")
            print(f"resumed from step {start}")

    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=args.seq_len,
                                global_batch=args.batch), device)
    batches = (ds.batch_at(start + i) for i in range(args.steps - start))
    wd = StragglerWatchdog()
    params, opt_state, losses = train(
        params, cfg, opt_cfg, batches,
        TrainConfig(microbatch=args.microbatch,
                    grad_compress=args.grad_compress),
        ckpt_manager=mgr, ckpt_every=args.ckpt_every, start_step=start,
        log_every=10, watchdog=wd, opt_state=opt_state, residuals=residuals)
    if wd.flagged:
        print(f"straggler watchdog flagged {len(wd.flagged)} slow steps")
    if mgr:
        mgr.wait()
    return SimpleNamespace(cfg=cfg, params=params, opt_state=opt_state,
                           losses=losses, start=start, watchdog=wd)


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
