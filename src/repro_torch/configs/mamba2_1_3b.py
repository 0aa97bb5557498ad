"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048 (attn-free) vocab=50280, ssm_state=128. CURing's Q/K/Gate
targets do not exist; the adapted target is the pre-SiLU in_proj
(DESIGN.md §5).
"""
from repro_torch.configs.base import MAMBA, MLP, BlockSpec, ModelConfig

# Mamba-2 blocks have no separate channel mixer; the block IS the mixer.
_B = BlockSpec(MAMBA, "none")

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    d_model=2048,
    n_layers=48,
    d_ff=0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    vocab_size=50_280,
    tie_embeddings=True,
    groups=(((_B,), 48),),
    cur_targets=("w_x",),
)

SMOKE = CONFIG.replace(
    name="mamba2-1.3b-smoke",
    d_model=64, n_layers=3, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    vocab_size=256, groups=(((_B,), 3),),
    scan_layers=False, dtype="float32",
)
