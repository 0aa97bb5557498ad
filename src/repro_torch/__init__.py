"""PyTorch/CUDA port of the CURing system (the JAX package ``repro`` is the
reference). Mirrors ``repro``'s module layout; imports nothing of ``repro``
and never ``jax``.

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when no CUDA device is present; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` or the default ``"cuda"``; raises if CUDA is asked for and
    absent (an entry point never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev
