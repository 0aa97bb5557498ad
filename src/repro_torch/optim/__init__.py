"""repro_torch.optim — AdamW with a cosine/warmup schedule and optional
int8 row-quantized moments (``repro.optim`` in the JAX package)."""
from repro_torch.optim.adamw import (
    STATE_FULL_KEYS, STATE_SCALE_KEYS, AdamW, dq8_rowwise, make_schedule,
    q8_rowwise, state_spec_from_param)

__all__ = ["AdamW", "STATE_FULL_KEYS", "STATE_SCALE_KEYS", "dq8_rowwise",
           "make_schedule", "q8_rowwise", "state_spec_from_param"]
