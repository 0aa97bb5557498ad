"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048. Backbone only: the
EnCodec frontend is a stub — input_specs() provides precomputed frame
embeddings (B, S, d_model); the output head predicts codebook ids (vocab
2048). Plain (non-gated) GELU FFN, so CURing targets the pre-activation
FFN weight w_up instead of w_gate (same Lipschitz argument).
"""
from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig

_B = BlockSpec(ATTN, MLP)

CONFIG = ModelConfig(
    name="musicgen-medium",
    d_model=1536,
    n_layers=48,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    mlp_act="gelu",
    gated_mlp=False,
    vocab_size=2048,
    input_mode="embeddings",
    groups=(((_B,), 48),),
    cur_targets=("wq", "wk", "w_up"),
)

SMOKE = CONFIG.replace(
    name="musicgen-medium-smoke",
    d_model=48, n_layers=3, n_heads=4, n_kv_heads=4, head_dim=12,
    d_ff=128, vocab_size=64, groups=(((_B,), 3),),
    scan_layers=False, dtype="float32",
)
