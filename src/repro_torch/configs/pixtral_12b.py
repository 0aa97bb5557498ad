"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. Backbone only:
the ViT patch encoder is a stub — input_specs() provides precomputed patch
embeddings (B, S, d_model).
"""
from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig

_B = BlockSpec(ATTN, MLP)

CONFIG = ModelConfig(
    name="pixtral-12b",
    d_model=5120,
    n_layers=40,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    rope_theta=1_000_000_000.0,
    input_mode="embeddings",
    groups=(((_B,), 40),),
    fsdp=True,
)

SMOKE = CONFIG.replace(
    name="pixtral-12b-smoke",
    d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, groups=(((_B,), 3),),
    scan_layers=False, fsdp=False, dtype="float32",
)
