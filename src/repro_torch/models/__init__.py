"""Model code of the port (every family of the JAX package)."""
from repro_torch.models.model import (
    decode_step, forward, forward_hidden, init_cache, init_params, loss_fn,
    prefill)

__all__ = ["decode_step", "forward", "forward_hidden", "init_cache",
           "init_params", "loss_fn", "prefill"]
