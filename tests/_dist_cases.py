"""The cases of tests/test_torch_dist.py, shared by the test, its torch
ranks (tests/_torch_dist_worker.py) and its JAX reference
(tests/_jax_dist_ref.py). Numpy only: every input is made here from a
seed, except the train cases' params, which the test draws with the JAX
package's ``init_params`` and passes to both sides."""
import numpy as np

WORLD = 8
MESHES = {"dm": ((2, 4), ("data", "model")),
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
