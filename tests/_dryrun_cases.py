"""The cases of tests/test_torch_dryrun.py, shared by its port worker
(tests/_torch_dryrun_worker.py) and its JAX reference
(tests/_jax_dryrun_ref.py). Plain Python only."""

MESH = ((2, 4), ("data", "model"))          # the fake / host-device mesh
TP_MESH = ((1, 4), ("data", "model"))       # the TP-only forward's

# ShapeConfig fields (name, seq_len, global_batch, kind) by cell kind
SHAPES = {"train": ("t16", 16, 8, "train"),
          "prefill": ("p16", 16, 8, "prefill"),
          "decode": ("d32", 32, 8, "decode")}

# argument bytes per rank: (arch, kind, paged, cur) on SMOKE configs
ARG_CELLS = [
    ("llama3.1-8b", "train", False, False),
    ("llama3.1-8b", "train", False, True),
    ("llama3.1-8b", "prefill", False, False),
    ("llama3.1-8b", "decode", False, False),
    ("llama3.1-8b", "decode", True, False),
    ("llama3.1-8b", "decode", True, True),
    ("mixtral-8x22b", "train", False, False),
    ("mixtral-8x22b", "decode", True, False),
    ("mamba2-1.3b", "prefill", False, False),
    ("mamba2-1.3b", "decode", False, False),
]

# extrapolated == direct: (arch, kind, paged); jamba's SMOKE at two
# periods of its 8-layer pattern, so that it has a repeat to extrapolate
EXTRAP_CELLS = [
    ("olmo-1b", "train", False), ("olmo-1b", "prefill", False),
    ("olmo-1b", "decode", False), ("olmo-1b", "decode", True),
    ("jamba-v0.1-52b", "train", False), ("jamba-v0.1-52b", "decode", False),
]
JAMBA_REPS = 2

TP_FORWARD = ("olmo-1b", 2, 8)              # arch, B, S of the TP forward


def smoke_cfg(get_smoke, arch):
    """The SMOKE config of a case (jamba's at JAMBA_REPS periods)."""
    cfg = get_smoke(arch)
    if arch.startswith("jamba"):
        pat = cfg.groups[0][0]
        cfg = cfg.replace(groups=((pat, JAMBA_REPS),),
                          n_layers=len(pat) * JAMBA_REPS)
    return cfg
