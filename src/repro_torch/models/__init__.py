"""Model code of the port (attention + MLP families)."""
from repro_torch.models.model import (
    forward, forward_hidden, init_params, loss_fn)

__all__ = ["forward", "forward_hidden", "init_params", "loss_fn"]
