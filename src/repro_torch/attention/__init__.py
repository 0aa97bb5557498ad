"""repro_torch.attention — the attention-backend registry.

Registration of the ``paged_prefill`` backends lives here so that
``prefill`` can call back into ``registry.mix`` without an import cycle.
"""
from repro_torch.attention import prefill, registry, xla
from repro_torch.attention.registry import (
    Backend, Caps, fold_q, mix, resolve, resolve_paged, resolve_prefill,
    unfold_o)

registry.register("paged_prefill", registry.Backend(
    "rank_fold", registry.Caps(window=True), prefill.fold_prefill))
registry.register("paged_prefill", registry.Backend(
    "reconstruct", registry.Caps(window=True), prefill.reconstruct_prefill))

__all__ = ["Backend", "Caps", "fold_q", "mix", "prefill", "registry",
           "resolve", "resolve_paged", "resolve_prefill", "unfold_o", "xla"]
