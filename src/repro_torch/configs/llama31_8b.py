"""llama3.1-8b — the paper's own experimental model [arXiv:2407.21783].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig

_B = BlockSpec(ATTN, MLP)

CONFIG = ModelConfig(
    name="llama3.1-8b",
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    groups=(((_B,), 32),),
)

# The CPU-scale reproduction model: same family/shape ratios, ~8M params.
# Used by examples + quality benchmarks (Fig. 4-7 analogues).
REPRO = CONFIG.replace(
    name="llama-repro-8m",
    d_model=256, n_layers=8, n_heads=8, n_kv_heads=4, head_dim=32,
    d_ff=704, vocab_size=4096, groups=(((_B,), 8),),
    scan_layers=False, dtype="float32",
)

SMOKE = CONFIG.replace(
    name="llama3.1-8b-smoke",
    d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, groups=(((_B,), 3),),
    scan_layers=False, dtype="float32",
)
