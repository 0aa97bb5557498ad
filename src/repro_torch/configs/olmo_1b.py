"""olmo-1b [dense] — non-parametric LN [arXiv:2402.00838; hf].

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig

_B = BlockSpec(ATTN, MLP)

CONFIG = ModelConfig(
    name="olmo-1b",
    d_model=2048,
    n_layers=16,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    tie_embeddings=True,
    norm_type="layernorm",
    parametric_norm=False,   # OLMo's distinguishing feature
    groups=(((_B,), 16),),
)

SMOKE = CONFIG.replace(
    name="olmo-1b-smoke",
    d_model=64, n_layers=3, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=256, groups=(((_B,), 3),),
    scan_layers=False, dtype="float32",
)
