"""Port parity for the optimizer and the error-feedback gradient
compression: the same numpy params and gradients through the JAX
package's AdamW / schedule / int8 quantizers / EF compression and the
port's. Params, moments and residuals within 2e-5 (scale-relative);
int8 codes and steps equal. Identical gradients go into both, so
gradient noise cannot flip the sign of a near-zero Adam step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.dist import compression as jcomp
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs.base import OptimizerConfig
from repro_torch.dist import compression as tcomp
from repro_torch.dist.checkpoint import tree_flatten
from repro_torch.optim import adamw as tadamw

from _torch_helpers import assert_close

torch.set_num_threads(1)


def test_optimizer_config_fields_match_jax():
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro_torch.configs.base import TrainConfig
    for jcls, tcls in ((JaxOptimizerConfig, OptimizerConfig),
                       (JaxTrainConfig, TrainConfig)):
        assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())


@pytest.mark.parametrize("schedule,warmup,total", [
    ("cosine", 10, 100), ("cosine", 0, 7), ("constant", 5, 50),
    ("cosine", 20, 300)])
def test_schedule_matches_jax(schedule, warmup, total):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total,
              schedule=schedule)
    jl = jadamw.make_schedule(JaxOptimizerConfig(**kw))
    tl = tadamw.make_schedule(OptimizerConfig(**kw))
    steps = range(total + 5)
    got = [tl(torch.tensor(s, dtype=torch.int32)) for s in steps]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    # the schedule is one f32 array over the steps, held scale-relative
    # like every other output: near the cosine's end 1 + cos(pi t)
    # cancels, and torch's and XLA's f32 cos differ there by 1 ulp
    assert_close(np.array([float(g) for g in got], np.float32),
                 np.array([float(jl(jnp.int32(s))) for s in steps],
                          np.float32))


def _params(rng):
    """A tree with a stacked (reps, m, n) weight, a 2-D weight, a stacked
    norm scale (2-D, so decayed: JAX's p.ndim >= 2 rule), a 1-D leaf and
    a frozen (None) leaf."""
    return {"groups": [[{"w": rng.standard_normal((2, 6, 10)),
                         "scale": 1.0 + 0.1 * rng.standard_normal((2, 10)),
                         "frozen": None}]],
            "head": rng.standard_normal((10, 12)),
            "bias": 0.1 * rng.standard_normal((12,))}


def _grads(params, rng, scale):
    return jax.tree.map(
        lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
        params)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("grad_scale", [0.1, 10.0])   # unclipped / clipped
def test_adamw_matches_jax(quantized, grad_scale):
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10,
              quantized_state=quantized)
    jopt = jadamw.AdamW(JaxOptimizerConfig(**kw))
    topt = tadamw.AdamW(OptimizerConfig(**kw))
    rng = np.random.default_rng(0)
    p_np = _f32(_params(rng))
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = bridge.to_torch(p_np, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["moments"]["groups"][0][0]["frozen"] is None
    for step in range(6):
        g_np = _grads(p_np, rng, grad_scale)
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g_np), js)
        tp, ts = topt.update(tp, bridge.to_torch(g_np, "cpu"), ts)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        jl = jax.tree.leaves(jax.device_get({"p": jp, "s": js}))
        tl = tree_flatten({"p": tp, "s": ts})
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert a.shape == tuple(b.shape)
            if b.dtype == np.int8:
                assert a.dtype == torch.int8
                np.testing.assert_array_equal(a.numpy(), b)
            elif b.dtype == np.float32:
                assert_close(a.numpy(), b)


def test_adamw_state_bridges_with_none_and_int8():
    """A healing-style state (frozen leaves None) with int8 codes crosses
    the bridge both ways."""
    kw = dict(quantized_state=True)
    p = {"a": jnp.ones((3, 4)), "b": None}
    js = jadamw.AdamW(JaxOptimizerConfig(**kw)).init(p)
    ts = bridge.to_torch(jax.device_get(js), "cpu")
    assert ts["moments"]["b"] is None
    assert ts["moments"]["a"]["m_q"].dtype == torch.int8
    back = bridge.to_numpy(ts)
    assert back["moments"]["b"] is None
    assert back["moments"]["a"]["v_q"].dtype == np.int8
    assert bridge.tree_map(lambda t: t, None) is None


@pytest.mark.parametrize("shape", [(4, 64), (3, 5, 16), (7,)])
def test_q8_rowwise_matches_jax(shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 5).astype(
        np.float32)
    jq, js = jadamw.q8_rowwise(jnp.asarray(x))
    tq, ts = tadamw.q8_rowwise(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert_close(ts.numpy(), np.asarray(js))
    assert_close(tadamw.dq8_rowwise(tq, ts).numpy(),
                 np.asarray(jadamw.dq8_rowwise(jq, js)))
    v = np.abs(x)
    jq, js = jadamw._q8_sqrt(jnp.asarray(v))
    tq, ts = tadamw._q8_sqrt(torch.from_numpy(v))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert_close(tadamw._dq8_sqrt(tq, ts).numpy(),
                 np.asarray(jadamw._dq8_sqrt(jq, js)))


def test_round_half_to_even_like_jax():
    x = np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 127.0]], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


def test_state_spec_from_param_matches_jax():
    entries = ["data", None, "model"]
    for key in tadamw.STATE_FULL_KEYS + tadamw.STATE_SCALE_KEYS + ("step",):
        assert tadamw.state_spec_from_param(entries, key) == \
            jadamw.state_spec_from_param(entries, key)
    with pytest.raises(KeyError):
        tadamw.state_spec_from_param(entries, "bogus")


def test_decoupled_weight_decay_follows_ndim_rule():
    cfg = OptimizerConfig(lr=1e-2, weight_decay=1.0, warmup_steps=1,
                          total_steps=10, schedule="constant")
    opt = tadamw.AdamW(cfg)
    p = {"w": torch.ones((4, 4)), "stacked_scale": torch.ones((2, 4)),
         "b": torch.ones((4,))}
    g = bridge.tree_map(torch.zeros_like, p)
    p2, _ = opt.update(p, g, opt.init(p))
    assert float(p2["w"].max()) < 1.0
    assert float(p2["stacked_scale"].max()) < 1.0   # ndim 2: decayed
    assert torch.equal(p2["b"], p["b"])
    assert p2["w"] is not p["w"] and torch.equal(p["w"], torch.ones(4, 4))


def test_ef_compress_matches_jax():
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 32), "b": (2, 3, 16), "c": (8,)}
    jr = jcomp.init_residuals({k: jnp.zeros(s) for k, s in shapes.items()})
    tr = tcomp.init_residuals({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(5):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        jc, jr = jcomp.ef_compress_grads(
            jax.tree.map(jnp.asarray, g), jr)
        tc, tr = tcomp.ef_compress_grads(bridge.to_torch(g, "cpu"), tr)
        for k in shapes:
            assert_close(tc[k].numpy(), np.asarray(jc[k]))
            assert_close(tr[k].numpy(), np.asarray(jr[k]))
            assert tr[k].dtype == torch.float32


def test_wire_bytes_matches_jax():
    for shape in ((4096, 1024), (8, 16, 32), (10,)):
        for compressed in (False, True):
            assert tcomp.wire_bytes(shape, torch.float32, compressed) == \
                jcomp.wire_bytes(shape, jnp.float32, compressed)
        assert tcomp.wire_bytes(shape, torch.bfloat16) == \
            jcomp.wire_bytes(shape, jnp.bfloat16)


def test_quantized_state_checkpoint_crosses_packages(tmp_path):
    """int8 codes and None (frozen) moments in checkpoints: written under
    the tag "int8" by either package's manager, restored by the other's
    bit-identical."""
    import json
    from repro.dist.checkpoint import CheckpointManager as JaxManager
    from repro_torch.dist.checkpoint import CheckpointManager
    kw = dict(lr=1e-2, warmup_steps=1, quantized_state=True)
    p_np = _f32(_params(np.random.default_rng(4)))
    jp = jax.tree.map(jnp.asarray, p_np)
    jopt = jadamw.AdamW(JaxOptimizerConfig(**kw))
    js = jopt.init(jp)
    jp, js = jopt.update(jp, jax.tree.map(
        jnp.asarray, _grads(p_np, np.random.default_rng(5), 1.0)), js)
    JaxManager(str(tmp_path / "jax")).save(1, {"opt_state": js})
    ts = bridge.to_torch(jax.device_get(js), "cpu")
    _, back = CheckpointManager(str(tmp_path / "jax")).restore(
        {"opt_state": ts}, device="cpu")
    a, b = tree_flatten(back), tree_flatten({"opt_state": ts})
    assert len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert back["opt_state"]["moments"]["groups"][0][0]["frozen"] is None
    CheckpointManager(str(tmp_path / "port")).save(1, {"opt_state": ts})
    with open(tmp_path / "port" / "step_00000001" / "manifest.json") as f:
        tags = {e["dtype"] for e in json.load(f)["leaves"]}
    assert tags == {"int8", "float32", "int32"}
    _, jback = JaxManager(str(tmp_path / "port")).restore({"opt_state": js})
    for x, y in zip(jax.tree.leaves(jax.device_get(jback)),
                    jax.tree.leaves(jax.device_get(js))):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
