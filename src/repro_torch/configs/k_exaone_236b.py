"""k-exaone-236b-a23b [moe] — LG AI's K-EXAONE 236B-A23B
[hf: LGAI-EXAONE/K-EXAONE-236B-A23B config.json].

48L d_model=6144 64H (GQA kv=8, head dim 128) vocab=153600 untied. Layer 0
is a dense SwiGLU of 18432; layers 1-47 are MoE: 128 experts of width
2048, top-8, sigmoid scores (f32 logits) renormalized over the top 8 and
scaled by 2.5, plus one shared expert of width 2048. Attention follows
"LLLG": a 128-token window on three layers, then one full layer.

The block is EXAONE 4's (arXiv:2507.11407; the config does not state
it): q / k RMSNorm per head, RMSNorm on each sub-block's output before
the residual add and none on its input, RoPE (theta 1e6) on the window
layers and NoPE on the full ones. No routing selection bias is modelled
(the config names no ``topk_method``); the multi-token-prediction layer
is left out. Registered beside ``ARCHS`` (``PORT_ARCHS``): the JAX
package has no such model.
"""
from repro_torch.configs.base import (
    ATTN, ATTN_LOCAL, MLP, MOE, BlockSpec, ModelConfig)

_DENSE = BlockSpec(ATTN_LOCAL, MLP)
_L = BlockSpec(ATTN_LOCAL, MOE)
_G = BlockSpec(ATTN, MOE)
_PERIOD = (_L, _L, _L, _G)

CUR_TARGETS = ("wq", "wk", "w_gate", "shared.w_gate", "experts.w_gate")

CONFIG = ModelConfig(
    name="k-exaone-236b-a23b",
    d_model=6144,
    n_layers=48,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    window=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
    rope_on_global=False,
    d_ff=18432,
    moe_d_ff=2048,
    n_experts=128,
    n_experts_per_tok=8,
    n_shared_experts=1,
    moe_scoring="sigmoid",
    routed_scaling=2.5,
    vocab_size=153_600,
    norm_eps=1e-5,
    block_norm="output",
    # layer 0 dense; layers 1-3 close the first LLLG period; 11 more
    groups=(((_DENSE,), 1), ((_L,), 2), ((_G,), 1), (_PERIOD, 11)),
    moe_impl="dense",
    cur_targets=CUR_TARGETS,
)

SMOKE = CONFIG.replace(
    name="k-exaone-236b-a23b-smoke",
    d_model=64, n_layers=8, n_heads=4, n_kv_heads=2, head_dim=16,
    window=8, d_ff=128, moe_d_ff=32, n_experts=8, n_experts_per_tok=2,
    vocab_size=256,
    groups=(((_DENSE,), 1), ((_L,), 2), ((_G,), 1), (_PERIOD, 1)),
    scan_layers=False, dtype="float32",
)
