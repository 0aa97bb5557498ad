"""repro_torch.serve — the static-batch engine over the dense KV cache
(``repro.serve`` in the JAX package)."""
from repro_torch.serve.engine import (
    GenerationResult, generate, make_prefill, make_serve_step)

__all__ = ["GenerationResult", "generate", "make_prefill",
           "make_serve_step"]
