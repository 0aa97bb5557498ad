"""repro_torch.dist — the distributed substrate (``repro.dist`` in the
JAX package): sharding rules, fault-tolerant checkpointing, elastic
recovery planning, and compressed collectives.

sharding     PartitionSpec derivation for params / optimizer state / caches /
             batches on (data, model) and (pod, data, model) meshes, with
             dispatch on CUR-factorized dict leaves; DTensor placement.
checkpoint   Atomic, checksummed, keep-N, async CheckpointManager on the
             JAX package's on-disk format.
elastic      Post-failure data-parallel re-planning (pow-2 + spares).
compression  Error-feedback int8-compressed gradient collectives.
collectives  Collectives over named mesh axes that carry gradients (the
             port's explicit form of ``shard_map``).
"""
from repro_torch.dist.checkpoint import (
    CheckpointManager, TensorSpec, load_tree_template, save_tree_template,
    template_from, tree_flatten, tree_template, tree_unflatten)

__all__ = ["CheckpointManager", "TensorSpec", "load_tree_template",
           "save_tree_template", "template_from", "tree_flatten",
           "tree_template", "tree_unflatten"]
