"""Single-card roofline costs of the NVIDIA H100 SXM (``analysis``): the
latency model behind ``repro_torch.plan``'s ``--budget-latency-ms``."""
from repro_torch.roofline.analysis import (
    HBM_BW, PEAK_FLOPS, cur_latency_s, gemm_latency_s, model_flops)

__all__ = ["HBM_BW", "PEAK_FLOPS", "cur_latency_s", "gemm_latency_s",
           "model_flops"]
