"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196; hf].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig

_B = BlockSpec(ATTN, MLP)

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    d_model=7168,
    n_layers=62,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32_256,
    rope_theta=100_000.0,
    groups=(((_B,), 62),),
    fsdp=True,
)

SMOKE = CONFIG.replace(
    name="deepseek-coder-33b-smoke",
    d_model=56, n_layers=3, n_heads=7, n_kv_heads=1, head_dim=8,
    d_ff=144, vocab_size=256, groups=(((_B,), 3),),
    scan_layers=False, fsdp=False, dtype="float32",
)
