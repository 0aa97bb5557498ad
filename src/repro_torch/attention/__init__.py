"""repro_torch.attention — the attention-backend registry (``mix`` only)."""
from repro_torch.attention import registry, xla
from repro_torch.attention.registry import Backend, Caps, mix, resolve

__all__ = ["Backend", "Caps", "mix", "registry", "resolve", "xla"]
