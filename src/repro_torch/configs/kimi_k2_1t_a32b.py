"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table)
[arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (expert dim) vocab=163840,
MoE 384e top-8 + 1 shared expert; first layer dense (DeepSeek-V3-style).
"""
from repro_torch.configs.base import ATTN, MLP, MOE, BlockSpec, ModelConfig

_DENSE = BlockSpec(ATTN, MLP)
_MOE = BlockSpec(ATTN, MOE)

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    d_model=7168,
    n_layers=61,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,            # dense first-layer FFN (DeepSeek-V3 convention)
    moe_d_ff=2048,         # per-expert intermediate dim (assignment d_ff)
    n_experts=384,
    n_experts_per_tok=8,
    n_shared_experts=1,
    vocab_size=163_840,
    rope_theta=50_000.0,
    groups=(((_DENSE,), 1), ((_MOE,), 60)),
    fsdp=True,
    moe_impl="a2a",
)

SMOKE = CONFIG.replace(
    name="kimi-k2-1t-a32b-smoke",
    d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=32, n_experts=8, n_experts_per_tok=2,
    n_shared_experts=1, vocab_size=256,
    groups=(((_DENSE,), 1), ((_MOE,), 2)),
    scan_layers=False, fsdp=False, moe_impl="dense", dtype="float32",
)
