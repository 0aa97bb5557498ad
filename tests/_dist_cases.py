"""The cases of tests/test_torch_dist.py, shared by the test, its torch
ranks (tests/_torch_dist_worker.py) and its JAX reference
(tests/_jax_dist_ref.py). Numpy only: every input is made here from a
seed, except the train cases' params, which the test draws with the JAX
package's ``init_params`` and passes to both sides."""
import numpy as np

WORLD = 8
MESHES = {"dm": ((2, 4), ("data", "model")),
          "md": ((4, 2), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model"))}

# name: (mesh, E, k, capacity_factor, B, S, layout) on mixtral's SMOKE
# widths. Capacity 8.0 drops nothing; 1.25 (the config's) and 1.0 drop
# tokens.
MOE_CASES = {
    "dm-a2a-E4": ("dm", 4, 2, 8.0, 4, 16, "tp"),
    "dm-a2a-E8": ("dm", 8, 2, 8.0, 4, 16, "tp"),
    "dm-tp-E2": ("dm", 2, 1, 8.0, 4, 16, "tp"),
    "dm-a2a-E4-drop": ("dm", 4, 2, 1.25, 4, 16, "tp"),
    "dm-a2a-E8-drop": ("dm", 8, 2, 1.25, 4, 16, "tp"),
    "dm-tp-E2-drop": ("dm", 2, 1, 1.25, 4, 16, "tp"),
    "dm-decode-E4": ("dm", 4, 2, 1.25, 4, 1, "tp"),     # S 1: the TP body
    "dm-decode-E4-nodrop": ("dm", 4, 2, 8.0, 4, 1, "tp"),
    "dm-a2a-E4-B1": ("dm", 4, 2, 1.25, 1, 16, "tp"),    # B 1: no data split
    "dm-fsdp-E4": ("dm", 4, 2, 1.25, 8, 4, "fsdp"),     # rows over (d, m)
    "pdm-a2a-E4-drop": ("pdm", 4, 2, 1.25, 4, 16, "tp"),
    "pdm-tp-E3-drop": ("pdm", 3, 2, 1.0, 4, 16, "tp"),
    "pdm-decode-E4": ("pdm", 4, 2, 1.25, 4, 1, "tp"),
}
MOE_D, MOE_F = 64, 96                       # mixtral SMOKE's d_model, F

# train models: (arch, overrides of its SMOKE config)
MODELS = {
    "olmo": ("olmo-1b", dict(d_model=64, n_heads=4, n_kv_heads=4,
                             head_dim=16, d_ff=128, vocab_size=256)),
    "mixtral-a2a": ("mixtral-8x22b", dict(moe_impl="a2a",
                                          capacity_factor=8.0)),
    "mixtral-tp": ("mixtral-8x22b", dict(moe_impl="a2a", capacity_factor=8.0,
                                         n_experts=2)),
}
# sharded train steps: name -> (model, mesh)
TRAIN = {"olmo-dm": ("olmo", "dm"), "olmo-pdm": ("olmo", "pdm"),
         "mixtral-a2a-dm": ("mixtral-a2a", "dm"),
         "mixtral-a2a-pdm": ("mixtral-a2a", "pdm"),
         "mixtral-tp-dm": ("mixtral-tp", "dm")}
EF_TRAIN = {"olmo-ef-dm": ("olmo", "dm")}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)
STEPS, TRAIN_B, TRAIN_S = 3, 4, 32

# the mesh step's loss and gradients against JAX's GSPMD step: name ->
# (mesh, microbatch, mask kind, B, model, fsdp). "random" masks keep a
# different share of each row (one row none, one row all), "ragged" ones
# a prefix of each row (one row empty). micro 4 on dm: B_local 4 <= micro
# < B 8; micro 3 does not divide over data 2; micro 2 on pdm is below its
# 4 batch ranks. jamba's case holds Mamba-2 on local heads (8 over 4), its
# attention's gather fallback and a dense-impl MoE, all FSDP.
MASKED = {
    "masked-dm": ("dm", 0, "random", 8, "olmo", False),
    "ragged-pdm": ("pdm", 0, "ragged", 8, "olmo", False),
    "micro-dm": ("dm", 4, "ragged", 8, "olmo", False),
    "micro-pdm": ("pdm", 4, "random", 8, "olmo", False),
    "micro-odd-dm": ("dm", 3, "ragged", 6, "olmo", False),
    "micro-unmasked-pdm": ("pdm", 2, None, 8, "olmo", False),
    "jamba-fsdp-dm": ("dm", 0, "ragged", 8, "jamba", True),
}

# placed train steps: name -> (model, mesh, fsdp, int8 moments). Each
# rank holds its shards of the params and moments; after PLACED_STEPS
# steps they are held to the slices of JAX's device at the same mesh
# position. olmo runs with fsdp off and on on both meshes (with f32 and
# int8 moments). "olmo-gqa" has 2 kv heads (model 4 cuts through them: the
# gather fallback); "cur" is olmo with wq folded {CU, R}, w_gate in
# healing form (column-parallel), wo folded and w_down in healing form
# (row-parallel: the rank-space all-reduce).
PLACED = {
    "olmo-dm": ("olmo", "dm", False, False),
    "olmo-fsdp-pdm": ("olmo", "pdm", True, False),
    "int8-fsdp-dm": ("olmo", "dm", True, True),
    "int8-pdm": ("olmo", "pdm", False, True),
    "mixtral-a2a-fsdp-dm": ("mixtral-a2a", "dm", True, False),
    "mixtral-a2a-pdm": ("mixtral-a2a", "pdm", False, False),
    "mixtral-tp-fsdp-dm": ("mixtral-tp", "dm", True, False),
    "cur-fsdp-dm": ("cur", "dm", True, False),
    "cur-pdm": ("cur", "pdm", False, False),
    "gqa-dm": ("olmo-gqa", "dm", False, False),
}
PLACED_STEPS = 2
# the placed models beyond MODELS: name -> (arch, overrides of its SMOKE)
PLACED_MODELS = {
    "cur": MODELS["olmo"],
    "olmo-gqa": ("olmo-1b", dict(MODELS["olmo"][1], n_kv_heads=2)),
    "jamba": ("jamba-v0.1-52b", {}),      # Mamba-2 + attention + MoE
}
CUR_RANK = 8
# the placed case whose kept tensors are counted, and the restore case: a
# checkpoint of olmo's params (f32 and a bf16 copy) read into the fsdp
# layout on dm
BYTES_CASE = "cur-fsdp-dm"
RESTORE = ("olmo", "dm")

# distribute(): (mesh, spec, global shape)
DIST_SPECS = {
    "data-rows": ("dm", ("data", None), (8, 6)),
    "model-cols": ("dm", (None, "model"), (6, 8)),
    "data-model-rows": ("dm", (("data", "model"), None), (16, 3)),
    "model-rows-data-cols": ("dm", ("model", "data"), (8, 4)),
    "replicated": ("dm", None, (4, 4)),
    "pod-data-rows": ("pdm", (("pod", "data"), None, "model"), (8, 3, 4)),
    "pod-rows-data-model-cols": ("pdm", ("pod", None, ("data", "model")),
                                 (2, 3, 8)),
}

PSUM_AXES = {"all": ("dm", ("data", "model")), "model": ("dm", "model"),
             "pod-data": ("pdm", ("pod", "data"))}
EF_ROUNDS = 50

GEN = dict(model="mixtral-a2a", B=4, S=8, new=4, fwd_S=16)

# elastic restart on the 8 ranks: ranks 1 and 5 failed, TP width 2
RECOVERY = dict(failed=(1, 5), tp=2)


# placed serving: the engine's prefill + SERVE_STEPS greedy decode steps on
# a cache placed per cache_pspecs, and the paged runtime's prefill +
# SERVE_STEPS decode steps + one verify window on a pool placed per
# paged_cache_pspecs; name -> (model, mesh, paged pool specs: "kernel",
# "einsum" or None for no paged run). llama's SMOKE has 2 kv heads of 16:
# model 2 holds a head a rank, model 4 cuts head_dim (the cache's head_dim
# fallback; the kernel's pool replicates). "hd18" (head_dim 18) divides
# neither, so its cache falls back to the cache length. mamba2 runs on
# local heads (8 over 2 and 4; its B / C tails shard by feature); "h2" (2
# heads of 64) gathers. mixtral (local attention, window 16, and MoE:
# the a2a body in prefill, the TP body in decode) wraps its ring buffer.
SERVE = {
    "llama-dm": ("llama", "dm", "kernel"),
    "llama-md": ("llama", "md", "kernel"),
    "llama-einsum-dm": ("llama", "dm", "einsum"),
    "hd18-dm": ("llama-hd18", "dm", None),
    "mamba2-dm": ("mamba2", "dm", None),
    "mamba2-md": ("mamba2", "md", None),
    "mamba2-h2-dm": ("mamba2-h2", "dm", None),
    "mixtral-dm": ("mixtral-serve", "dm", "kernel"),
    "mixtral-md": ("mixtral-serve", "md", "kernel"),
}
SERVE_MODELS = {
    "llama": ("llama3.1-8b", {}),
    "llama-hd18": ("llama3.1-8b", dict(head_dim=18)),
    "mamba2": ("mamba2-1.3b", {}),
    "mamba2-h2": ("mamba2-1.3b", dict(ssm_head_dim=64)),
    "mixtral-serve": ("mixtral-8x22b", dict(moe_impl="a2a",
                                            capacity_factor=8.0)),
}
SERVE_STEPS = 3
SERVE_B, SERVE_S = 4, 16                    # prompts; the cache holds S + 4
PAGED_BS, PAGED_MAXB = 8, 4                 # block size, table width
PAGED_LENS = (16, 11, 16, 5)                # ragged prompts
SPEC_K = 2                                  # the verify window's drafts


def serve_inputs(vocab, name):
    """(prompts (B, S), paged draft tokens (B, SPEC_K)) of a SERVE case."""
    rng = np.random.default_rng(30 + sorted(SERVE).index(name))
    return (rng.integers(0, vocab, (SERVE_B, SERVE_S)).astype(np.int32),
            rng.integers(0, vocab, (SERVE_B, SPEC_K)).astype(np.int32))


def paged_table():
    """Slot b's blocks: b * PAGED_MAXB onwards (every slot's table full)."""
    return np.arange(SERVE_B * PAGED_MAXB, dtype=np.int32).reshape(
        SERVE_B, PAGED_MAXB)


def moe_inputs(name):
    """(x (B, S, D), p {router, w_gate, w_up, w_down}) of a MoE case."""
    _, E, _, _, B, S, _ = MOE_CASES[name]
    rng = np.random.default_rng(sorted(MOE_CASES).index(name))
    D, F = MOE_D, MOE_F

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    p = {"router": w(D, E), "w_gate": w(E, D, F), "w_up": w(E, D, F),
         "w_down": w(E, F, D)}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, p


def moe_overrides(name):
    _, E, k, cf, _, _, layout = MOE_CASES[name]
    return dict(n_experts=E, n_experts_per_tok=k, moe_impl="a2a",
                capacity_factor=cf, layout=layout)


def train_batches(vocab, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


# a q8 row scale over a last dim sharded over 'model' (and rows over
# 'data'): the codes and scales of each rank's block against JAX's
# quantizer on the whole tensor
Q8_SPEC = ("data", "model")


def q8_inputs():
    rng = np.random.default_rng(15)
    return (rng.standard_normal((6, 64)) * np.exp(rng.standard_normal(
        (6, 1)))).astype(np.float32)


def psum_inputs():
    return np.random.default_rng(11).standard_normal(
        (WORLD, 64)).astype(np.float32)


def ef_inputs():
    return np.random.default_rng(12).standard_normal(
        (WORLD, 4, 256)).astype(np.float32)


def gen_inputs(vocab):
    rng = np.random.default_rng(13)
    return (rng.integers(0, vocab, (GEN["B"], GEN["S"])).astype(np.int32),
            rng.integers(0, vocab, (GEN["B"], GEN["fwd_S"])).astype(np.int32))


def model_args(model):
    """(arch, overrides) of a MODELS, PLACED_MODELS or SERVE_MODELS
    entry."""
    for table in (MODELS, PLACED_MODELS, SERVE_MODELS):
        if model in table:
            return table[model]
    raise KeyError(model)


def cur_params(params):
    """olmo's params (numpy) with its four CUR targets replaced by factors
    drawn from a seed: wq and wo folded {CU, R}, w_gate and w_down in
    healing form {C, U0, dU, R} (stacked over the group's repeats)."""
    rng = np.random.default_rng(14)
    r = CUR_RANK

    def a(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    out = {k: v for k, v in params.items() if k != "groups"}
    blocks = []
    for blk in params["groups"][0]:
        blk = dict(blk)
        for name, form in (("wq", "folded"), ("wo", "folded"),
                           ("w_gate", "heal"), ("w_down", "heal")):
            reps, m, n = blk[name].shape
            if form == "folded":
                blk[name] = {"CU": a(reps, m, r), "R": a(reps, r, n)}
            else:
                blk[name] = {"C": a(reps, m, r), "U0": a(reps, r, r),
                             "dU": 0.1 * a(reps, r, r), "R": a(reps, r, n)}
        blocks.append(blk)
    out["groups"] = [blocks]
    return out


def masked_batch(name, vocab):
    """tokens, labels and (unless the case has none) a float32 mask."""
    kind, B = MASKED[name][2:4]
    rng = np.random.default_rng(20 + sorted(MASKED).index(name))
    toks = rng.integers(0, vocab, (B, TRAIN_S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if kind == "random":
        keep = np.linspace(0.0, 1.0, B)[:, None]
        out["mask"] = (rng.random((B, TRAIN_S)) < keep).astype(np.float32)
    elif kind == "ragged":
        lens = rng.integers(1, TRAIN_S + 1, B)
        lens[0] = 0
        out["mask"] = (np.arange(TRAIN_S)[None] < lens[:, None]).astype(
            np.float32)
    return out
