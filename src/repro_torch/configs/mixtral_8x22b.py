"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2,
sliding window 4096 (per assignment).
"""
from repro_torch.configs.base import ATTN_LOCAL, MOE, BlockSpec, ModelConfig

_B = BlockSpec(ATTN_LOCAL, MOE)

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    d_model=6144,
    n_layers=56,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    window=4096,
    d_ff=16384,
    moe_d_ff=16384,
    n_experts=8,
    n_experts_per_tok=2,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
    groups=(((_B,), 56),),
    fsdp=True,
    moe_impl="a2a",
)

SMOKE = CONFIG.replace(
    name="mixtral-8x22b-smoke",
    d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16,
    window=16, d_ff=96, moe_d_ff=96, n_experts=4, n_experts_per_tok=2,
    vocab_size=256, groups=(((_B,), 3),),
    scan_layers=False, fsdp=False, moe_impl="dense", dtype="float32",
)
