"""The port's checkpoint manager: the JAX suite's manager cases
(tests/test_checkpoint.py) on torch trees, and the on-disk format shared
with ``repro.dist.checkpoint``: a checkpoint written by either package
restores bit-identical in the other, leaves numbered in
``jax.tree.leaves`` order, and the same tree gives the same files. The
chaos corruption of a port-written checkpoint: tests/test_torch_chaos.py."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_repro as jax_get_repro
from repro.configs.base import CURConfig as JaxCURConfig
from repro.core import calibrate as jax_calibrate
from repro.core import compress_model as jax_compress_model
from repro.dist import checkpoint as jckpt
from repro.models import init_params as jax_init_params
from repro_torch.dist import (
    CheckpointManager, TensorSpec, load_tree_template, save_tree_template,
    template_from, tree_flatten, tree_template, tree_unflatten)

from _torch_helpers import port_params

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "b": torch.zeros((8,))},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _zeros(tree):
    return tree_unflatten(tree, [torch.zeros_like(x)
                                 for x in tree_flatten(tree)])


def _equal(a, b):
    la, lb = tree_flatten(a), tree_flatten(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the manager (tests/test_checkpoint.py's cases)
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(3)
    mgr.save(3, t)
    step, restored = mgr.restore(_zeros(t), device="cpu")
    assert step == 3 and _equal(t, restored)


def test_tmp_dirs_are_not_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")   # simulated dead save
    mgr.save(2, _tree(2))
    assert mgr.all_steps() == [2]
    assert mgr.latest_valid_step() == 2
    assert not (tmp_path / "step_00000009.tmp").exists()


def test_corruption_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    with open(tmp_path / "step_00000002" / "leaf_00000.npy", "r+b") as f:
        f.seek(64)
        f.write(b"\xde\xad\xbe\xef")
    assert mgr.latest_valid_step() == 1
    step, restored = mgr.restore(_zeros(_tree(0)), device="cpu")
    assert step == 1 and int(restored["step"]) == 1


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.leaf_count(4) == 3


def test_async_save_snapshots_before_returning(tmp_path):
    """The host copy is taken inside save(): overwriting the tensors
    afterwards does not reach the files the thread writes."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(7)
    want = tree_unflatten(t, [x.clone() for x in tree_flatten(t)])
    mgr.save(7, t, blocking=False)
    t["params"]["w"].fill_(0.0)
    mgr.wait()
    assert mgr.latest_valid_step() == 7
    assert _equal(mgr.restore(_zeros(t), device="cpu")[1], want)


def test_blocking_save_retries_transient_io(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retries=2, backoff_s=0.001)
    attempts = []

    def flaky(attempt):
        attempts.append(attempt)
        if attempt < 2:
            raise OSError("disk hiccup")

    mgr.fault_hook = flaky
    mgr.save(5, _tree(5))
    assert attempts == [0, 1, 2]
    assert mgr.latest_valid_step() == 5


def _dead_disk(attempt):
    raise OSError("dead disk")


def test_blocking_save_exhausts_retries(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retries=1, backoff_s=0.001)
    mgr.fault_hook = _dead_disk
    with pytest.raises(OSError):
        mgr.save(5, _tree(5))
    assert mgr.latest_valid_step() is None


def test_async_save_failure_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retries=1, backoff_s=0.001)
    mgr.fault_hook = _dead_disk
    mgr.save(7, _tree(7), blocking=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.fault_hook = None
    mgr.save(8, _tree(8))
    assert mgr.latest_valid_step() == 8


def test_async_save_failure_surfaces_on_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.fault_hook = _dead_disk
    mgr.save(7, _tree(7), blocking=False)
    mgr.fault_hook = None
    with pytest.raises(OSError):
        mgr.save(8, _tree(8))                 # wait() inside save re-raises
    mgr.save(8, _tree(8))
    assert mgr.latest_valid_step() == 8


def test_async_save_retry_recovers(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retries=3, backoff_s=0.001)
    fails = {"n": 2}

    def flaky(attempt):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient")

    mgr.fault_hook = flaky
    mgr.save(9, _tree(9), blocking=False)
    mgr.wait()
    assert mgr.latest_valid_step() == 9


def test_restore_checks_leaf_count_and_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"w": TensorSpec((4, 8), torch.float32)}, device="cpu")
    bad = _zeros(_tree(0))
    bad["params"]["w"] = TensorSpec((8, 4), torch.float32)
    with pytest.raises(ValueError, match="template expects"):
        mgr.restore(bad, device="cpu")
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(bad, device="cpu")


# ---------------------------------------------------------------------------
# the format shared with repro.dist.checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cured():
    """A CURed REPRO tree from the JAX package (``{CU, R}`` dicts, norms,
    per-layer ``groups`` lists), with a bf16 copy of it, an int32 leaf and
    a None subtree: (jax tree, the same tree in the port)."""
    jcfg = jax_get_repro()
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 32))
    calib = jax_calibrate(jparams, jcfg, [{"tokens": jnp.asarray(toks)}])
    cparams, _, _ = jax_compress_model(
        jparams, jcfg, JaxCURConfig(r_max=16, n_compress_layers=2,
                                    svd="exact"), calib)
    jtree = {"params": cparams,
             "bf16": jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                  cparams),
             "step": jnp.asarray(11, jnp.int32), "none": None}
    ttree = port_params({k: v for k, v in jtree.items() if k != "none"})
    ttree["none"] = None
    return jtree, ttree


def _bits(x):
    """A leaf's raw bits as a numpy array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def test_leaf_order_equals_jax_tree_leaves(cured):
    jtree, ttree = cured
    jl, tl = jax.tree.leaves(jtree), tree_flatten(ttree)
    assert len(jl) == len(tl) > 50
    for a, b in zip(jl, tl):
        assert np.array_equal(_bits(a), _bits(b))
    # wq and wo have one shape in REPRO: only the values tell them apart
    layer = ttree["params"]["groups"][0][0]
    assert layer["wq"].shape == layer["wo"].shape


def test_template_json_equals_jax(cured, tmp_path):
    jtree, ttree = cured
    assert tree_template(ttree) == jckpt.tree_template(jtree)
    save_tree_template(str(tmp_path / "t.json"), ttree)
    tmpl = load_tree_template(str(tmp_path / "t.json"))
    assert tmpl["none"] is None
    assert tmpl["bf16"]["embed"] == TensorSpec(
        tuple(ttree["bf16"]["embed"].shape), torch.bfloat16)
    assert template_from(tree_template(ttree)) == tmpl


def test_same_tree_same_files(cured, tmp_path):
    """Saved by either package, one tree gives the same bytes in every
    leaf file and the same manifest."""
    jtree, ttree = cured
    jckpt.CheckpointManager(str(tmp_path / "j")).save(4, jtree)
    CheckpointManager(str(tmp_path / "t")).save(4, ttree)
    jd, td = tmp_path / "j" / "step_00000004", tmp_path / "t" / "step_00000004"
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    for name in names:
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    assert json.load(open(td / "manifest.json"))["n_leaves"] == len(
        tree_flatten(ttree))


def test_jax_written_checkpoint_restores_in_the_port(cured, tmp_path):
    jtree, ttree = cured
    jckpt.CheckpointManager(str(tmp_path)).save(5, jtree)
    jckpt.save_tree_template(str(tmp_path / "template.json"), jtree)
    tmpl = load_tree_template(str(tmp_path / "template.json"))
    step, restored = CheckpointManager(str(tmp_path)).restore(tmpl, device="cpu")
    assert step == 5 and restored["none"] is None
    assert _equal(restored, ttree)


def test_port_written_checkpoint_restores_in_jax(cured, tmp_path):
    jtree, ttree = cured
    CheckpointManager(str(tmp_path)).save(6, ttree)
    save_tree_template(str(tmp_path / "template.json"), ttree)
    tmpl = jckpt.load_tree_template(str(tmp_path / "template.json"))
    step, restored = jckpt.CheckpointManager(str(tmp_path)).restore(tmpl)
    assert step == 6
    jl, rl = jax.tree.leaves(jtree), jax.tree.leaves(restored)
    assert len(jl) == len(rl)
    for a, b in zip(jl, rl):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
