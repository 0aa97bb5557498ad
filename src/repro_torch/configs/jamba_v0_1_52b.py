"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536. Period-8 pattern:
attention at position 3, MoE at odd positions (1,3,5,7), mamba elsewhere.
"""
from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE, BlockSpec, ModelConfig

_Md = BlockSpec(MAMBA, MLP)
_Mm = BlockSpec(MAMBA, MOE)
_Am = BlockSpec(ATTN, MOE)

# period of 8: [M+mlp, M+moe, M+mlp, A+moe, M+mlp, M+moe, M+mlp, M+moe]
_PERIOD = (_Md, _Mm, _Md, _Am, _Md, _Mm, _Md, _Mm)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_d_ff=14336,
    n_experts=16,
    n_experts_per_tok=2,
    ssm_state=16,            # Jamba uses Mamba-1 d_state=16
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    vocab_size=65_536,
    groups=((_PERIOD, 4),),
    fsdp=True,
    moe_impl="a2a",
    cur_targets=("wq", "wk", "w_gate", "w_x"),
)

SMOKE = CONFIG.replace(
    name="jamba-v0.1-52b-smoke",
    d_model=64, n_layers=8, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, moe_d_ff=96, n_experts=4, n_experts_per_tok=2,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    vocab_size=256, groups=((_PERIOD, 1),),
    scan_layers=False, fsdp=False, moe_impl="dense", dtype="float32",
)
