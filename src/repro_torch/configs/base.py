"""Config dataclasses for the PyTorch port (a copy of ``repro.configs.base``;
the port imports nothing of ``repro``).

A model is described by a ``ModelConfig`` whose ``groups`` field lists
(pattern, repeats) scan groups; each pattern entry is a ``BlockSpec``
describing one decoder block (sequence-mixer + channel-mixer pair).

``CURConfig`` holds the CURing options, ``OptimizerConfig`` and
``TrainConfig`` those of training and healing. Field names and defaults
match the JAX package so a config means the same thing in both.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Block specs
# ---------------------------------------------------------------------------

# sequence mixers
ATTN = "attn"            # full causal attention
ATTN_LOCAL = "attn_local"  # sliding-window causal attention
MAMBA = "mamba"          # Mamba-2 SSD block

# channel mixers
MLP = "mlp"              # gated (SwiGLU) or plain (GELU) MLP per config
MOE = "moe"              # top-k routed mixture of experts


@dataclass(frozen=True)
class BlockSpec:
    """One decoder block: a sequence mixer followed by a channel mixer."""
    mixer: str = ATTN          # ATTN | ATTN_LOCAL | MAMBA
    mlp: str = MLP             # MLP | MOE

    @property
    def tag(self) -> str:
        return f"{self.mixer}+{self.mlp}"


# the fields of ModelConfig that the JAX package's lacks (their defaults
# keep its behaviour)
PORT_FIELDS = ("rope_on_global", "moe_scoring", "routed_scaling",
               "expert_first", "experts_held", "block_norm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0          # 0 -> d_model // n_heads
    window: int = 0            # sliding window size for ATTN_LOCAL
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    # False: NoPE on full-attention layers, RoPE on window layers only
    # (EXAONE 4's hybrid attention)
    rope_on_global: bool = True
    # mlp
    d_ff: int = 0
    mlp_act: str = "silu"      # "silu" (SwiGLU gated) | "gelu" (plain 2-layer)
    gated_mlp: bool = True
    # moe
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_d_ff: int = 0          # expert intermediate dim (kimi uses 2048)
    n_shared_experts: int = 0  # dense shared expert path (kimi-style)
    capacity_factor: float = 1.25
    # router scores: "softmax" (Mixtral) | "sigmoid" (DeepSeek-V3 style,
    # f32 logits); the top k are renormalized, then scaled by this
    moe_scoring: str = "softmax"
    routed_scaling: float = 1.0
    # the experts this device holds: [expert_first, expert_first +
    # experts_held) of the n_experts the router scores (0: all of them).
    # The absent experts add nothing (expert parallelism's share of a
    # layer, without its exchange)
    expert_first: int = 0
    experts_held: int = 0
    # mamba
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # embeddings
    vocab_size: int = 32_000
    tie_embeddings: bool = False
    embed_scale: bool = False      # multiply embeddings by sqrt(d) (gemma)
    # normalization
    norm_eps: float = 1e-5
    parametric_norm: bool = True   # olmo uses non-parametric LN
    norm_type: str = "rmsnorm"     # "rmsnorm" | "layernorm"
    # "input": norm1 / norm2 on each sub-block's input (pre-norm);
    # "output": on each sub-block's output before the residual add, the
    # sub-blocks reading the residual stream itself (EXAONE 4)
    block_norm: str = "input"
    # modality frontend stub: inputs may be precomputed embeddings
    input_mode: str = "tokens"     # "tokens" | "embeddings"
    # layer structure: tuple of (pattern tuple[BlockSpec], repeats)
    groups: Tuple[Tuple[Tuple[BlockSpec, ...], int], ...] = ()
    # compile strategy
    scan_layers: bool = True
    remat: bool = True
    # "full": recompute everything (baseline); "save_mixer_outputs":
    # checkpoint the attention/mamba/mlp sub-block outputs so the backward
    # pass does not re-execute their tensor-parallel all-reduces
    # (§Perf iteration 2)
    remat_policy: str = "full"
    # static (python-unrolled) attention chunk loops with causal tile
    # skipping — mirrors the Pallas kernel's pl.when dead-tile skipping;
    # used by the dry-run cost compiles (see launch/dryrun.py)
    static_loops: bool = False
    attn_chunk: int = 512
    # precision
    dtype: str = "bfloat16"
    # distribution hints
    fsdp: bool = False            # (tp layout) shard param dim-0 over 'data'
    moe_impl: str = "dense"       # "dense" | "a2a" (shard_map expert-parallel)
    # "tp": Megatron TP over 'model' (+optional ZeRO over 'data') — baseline.
    # "fsdp": pure ZeRO-3 — batch over ('data','model'), weights sharded
    # dim-0 over 'model' and gathered per layer, moments over both axes.
    # §Perf iteration 3: at 1M-token global batch the TP activation
    # all-reduces dwarf FSDP's weight gathers for dense archs.
    layout: str = "tp"
    # which weights CURing targets for this family (DESIGN.md §5)
    cur_targets: Tuple[str, ...] = ("wq", "wk", "w_gate")

    def __repr__(self) -> str:
        """The dataclass repr, leaving out the ``PORT_FIELDS`` that hold
        their defaults: a config both packages have reads as the JAX
        package's (and digests alike: ``plan.config_hash``)."""
        parts = [f"{f.name}={getattr(self, f.name)!r}"
                 for f in dataclasses.fields(self)
                 if not (f.name in PORT_FIELDS
                         and getattr(self, f.name) == f.default)]
        return f"{type(self).__qualname__}({', '.join(parts)})"

    # ---- derived -----------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def blocks(self) -> Tuple[BlockSpec, ...]:
        out = []
        for pattern, reps in self.groups:
            out.extend(list(pattern) * reps)
        assert len(out) == self.n_layers, (
            f"{self.name}: groups describe {len(out)} layers, "
            f"config says {self.n_layers}")
        return tuple(out)

    @property
    def n_local_experts(self) -> int:
        """Experts whose weights this device holds."""
        return self.experts_held or self.n_experts

    @property
    def d_inner(self) -> int:  # mamba inner dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for spec in self.blocks:
            if spec.mixer in (ATTN, ATTN_LOCAL):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
            elif spec.mixer == MAMBA:
                di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * st + nh)   # in_proj (zxbcdt fused)
                total += self.ssm_conv * (di + 2 * st)  # conv over x,B,C
                total += nh + nh                       # A_log, D
                total += di * d                        # out_proj
            if spec.mlp == MLP:
                ff = self.d_ff
                n_mats = 3 if self.gated_mlp else 2
                total += n_mats * d * ff
            elif spec.mlp == MOE:
                ff = self.moe_d_ff or self.d_ff
                total += self.n_local_experts * 3 * d * ff
                total += d * self.n_experts            # router
                if self.n_shared_experts:
                    total += self.n_shared_experts * 3 * d * ff
            if self.parametric_norm:
                total += 2 * d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed experts; of a
        held share, at most ``n_experts_per_tok`` of its experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        ff = self.moe_d_ff or self.d_ff
        held = self.n_local_experts
        for spec in self.blocks:
            if spec.mlp == MOE:
                inactive = held - min(self.n_experts_per_tok, held)
                total -= inactive * 3 * d * ff
        return total

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# archs allowed to run long_500k (sub-quadratic sequence mixing; DESIGN.md §5)
SUBQUADRATIC_ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b", "gemma3-1b",
                      "mixtral-8x22b")


def shape_applicable(arch_name: str, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return arch_name in SUBQUADRATIC_ARCHS
    return True


# ---------------------------------------------------------------------------
# CURing options
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CURConfig:
    enabled: bool = False
    r_max: int = 256
    n_compress_layers: int = 10     # how many layers to CUR (by angular dist)
    selection: str = "wanda_deim"   # wanda_deim|wanda|deim|weight|random
    layer_selection: str = "angular"  # angular|last|random
    calib_samples: int = 128
    svd: str = "exact"              # "exact" (paper) | "randomized" (ours)
    fold_u: bool = False            # fold C@U -> C' for inference
    seed: int = 0
    # "batched": one stacked call per shape-class (fast path);
    # "loop": per-weight reference — identical selections on fixed seeds
    pipeline: str = "batched"
    # per-weight rank allocation keyed "layer:name" (e.g. "3:wq"), as
    # emitted by ``repro.plan``. When set it is the COMPLETE allocation:
    # only the listed weights are compressed (a plan may deliberately
    # leave a weight dense when no rank saves parameters), at exactly the
    # listed ranks. Validated by ``compress_model``: keys must name
    # weights in the target set of the selected layers and ranks must
    # satisfy 1 <= r <= min(m, n). Both pipelines honor the allocation
    # identically (batched groups by (m, n, r)).
    ranks: Optional[Mapping[str, int]] = None


# ---------------------------------------------------------------------------
# Optimizer / training
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4                # paper App. B healing LR
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 2_000
    schedule: str = "cosine"
    quantized_state: bool = False   # int8 row-quantized m/v (for 1T-scale)
    state_block: int = 256


@dataclass(frozen=True)
class TrainConfig:
    microbatch: int = 0             # 0 -> no grad accumulation
    distill_alpha: float = 0.1      # paper App. B: CE weight (KD weight 0.9)
    distill_temp: float = 10.0
    seed: int = 0
    # error-feedback compressed gradients (repro_torch.dist.compression)
    grad_compress: str = "none"     # "none" | "ef_int8"
