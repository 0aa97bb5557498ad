"""Public fused CUR matmul op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors. Any other device raises.

The op is forward-only: asked for a gradient (grad mode on and an input
that requires one) it raises rather than return an output with no graph.
Differentiated CUR weights are in healing form ``{C, U0, dU, R}``, which
``apply_w`` runs as a chain of matmuls. Fake tensors (a dry run's) take the
shape-only path of ``kernels._fake``, and only they do."""
from __future__ import annotations

import torch

from repro_torch.kernels import _fake
from repro_torch.kernels.cur_matmul import cur_matmul as _kernel
from repro_torch.kernels.cur_matmul.ref import cur_matmul_ref


def cur_matmul_op(x: torch.Tensor, cu: torch.Tensor, r: torch.Tensor
                  ) -> torch.Tensor:
    """Fused (x @ CU) @ R. Accepts (..., m) inputs; flattens leading dims."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, cu, r)):
        raise RuntimeError(
            "cur_matmul_op has no backward: it takes no input that "
            "requires grad (train the healing form {C, U0, dU, R})")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _fake.is_fake(x, cu, r):
        y = _fake.cur_matmul(x2, cu, r)
    elif x.device.type == "cpu":
        y = cur_matmul_ref(x2, cu, r)
    elif x.device.type == "cuda":
        y = _kernel.cur_matmul(x2.contiguous(), cu.contiguous(),
                               r.contiguous())
    else:
        raise ValueError(f"cur_matmul_op: no kernel for {x.device}")
    return y.reshape(*lead, r.shape[1])
