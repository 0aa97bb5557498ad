"""gemma3-1b [dense] — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144. head_dim=256,
sliding window 512 on local layers.
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, MLP, BlockSpec, ModelConfig

_L = BlockSpec(ATTN_LOCAL, MLP)
_G = BlockSpec(ATTN, MLP)

# 26 layers: (5 local, 1 global) x 4, then 2 trailing local layers.
_PERIOD = (_L, _L, _L, _L, _L, _G)

CONFIG = ModelConfig(
    name="gemma3-1b",
    d_model=1152,
    n_layers=26,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    window=512,
    qk_norm=True,
    d_ff=6912,
    mlp_act="gelu",         # gemma uses GeGLU (gated gelu)
    gated_mlp=True,
    vocab_size=262_144,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=1_000_000.0,
    groups=((_PERIOD, 4), ((_L, _L), 1)),
)

SMOKE = CONFIG.replace(
    name="gemma3-1b-smoke",
    d_model=48, n_layers=8, n_heads=4, n_kv_heads=1, head_dim=16,
    window=8, d_ff=96, vocab_size=512,
    groups=((_PERIOD, 1), ((_L, _L), 1)),
    scan_layers=False, dtype="float32",
)
