"""repro_torch.dist — fault-tolerant checkpointing and error-feedback
gradient compression (``repro.dist`` in the JAX package; its sharding and
elastic modules and ``compressed_psum`` are not ported yet).

checkpoint   Atomic, checksummed, keep-N, async CheckpointManager on the
             JAX package's on-disk format.
compression  Error-feedback int8 gradient compression (one device).
"""
from repro_torch.dist.checkpoint import (
    CheckpointManager, TensorSpec, load_tree_template, save_tree_template,
    template_from, tree_flatten, tree_template, tree_unflatten)

__all__ = ["CheckpointManager", "TensorSpec", "load_tree_template",
           "save_tree_template", "template_from", "tree_flatten",
           "tree_template", "tree_unflatten"]
