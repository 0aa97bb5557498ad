"""Public fused CUR matmul op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors. Any other device raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.cur_matmul import cur_matmul as _kernel
from repro_torch.kernels.cur_matmul.ref import cur_matmul_ref


def cur_matmul_op(x: torch.Tensor, cu: torch.Tensor, r: torch.Tensor
                  ) -> torch.Tensor:
    """Fused (x @ CU) @ R. Accepts (..., m) inputs; flattens leading dims."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = cur_matmul_ref(x2, cu, r)
    elif x.device.type == "cuda":
        y = _kernel.cur_matmul(x2.contiguous(), cu.contiguous(),
                               r.contiguous())
    else:
        raise ValueError(f"cur_matmul_op: no kernel for {x.device}")
    return y.reshape(*lead, r.shape[1])
