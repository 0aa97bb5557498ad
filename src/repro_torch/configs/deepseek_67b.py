"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig

_B = BlockSpec(ATTN, MLP)

CONFIG = ModelConfig(
    name="deepseek-67b",
    d_model=8192,
    n_layers=95,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102_400,
    rope_theta=10_000.0,
    groups=(((_B,), 95),),
    fsdp=True,
)

SMOKE = CONFIG.replace(
    name="deepseek-67b-smoke",
    d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, groups=(((_B,), 3),),
    scan_layers=False, fsdp=False, dtype="float32",
)
