"""Port parity for the model layers, the attention paths and the whole
forward: the same numpy inputs and bridged params through the JAX package
and the port, f32, scale-relative 2e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import xla as jax_xla
from repro.configs import get_smoke as jax_get_smoke
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro.models.model import forward_hidden as jax_forward_hidden
from repro.models.model import loss_fn as jax_loss_fn
from repro_torch import bridge
from repro_torch.attention import registry as treg
from repro_torch.attention import xla as t_xla
from repro_torch.configs import get_smoke
from repro_torch.kernels.cur_matmul.ops import cur_matmul_op
from repro_torch.models import forward, forward_hidden, loss_fn
from repro_torch.models import layers as tl

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


def test_port_configs_equal_jax():
    for name in ("llama3.1-8b", "olmo-1b"):
        assert port_cfg(jax_get_smoke(name)) == get_smoke(name)
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    assert port_cfg(jax_get_config("llama3.1-8b")) == \
        get_config("llama3.1-8b")
    assert get_config("llama3.1-8b").param_count() == 8_030_261_248


@pytest.mark.parametrize("with_scale", [False, True])
def test_norms_match_jax(with_scale):
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    s = rng.standard_normal((64,), dtype=np.float32) if with_scale else None
    tx = torch.from_numpy(x)
    ts = torch.from_numpy(s) if with_scale else None
    js = jnp.asarray(s) if with_scale else None
    assert_close(tl.rms_norm(tx, ts).numpy(), jl.rms_norm(jnp.asarray(x), js))
    assert_close(tl.layer_norm(tx, ts).numpy(),
                 jl.layer_norm(jnp.asarray(x), js))


def test_rms_norm_keeps_bf16_data_path():
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    y = tl.rms_norm(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16


def test_apply_rope_matches_jax():
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32)[None], (2, 7)) + 3
    yt = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       500_000.0)
    yj = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    assert_close(yt.numpy(), yj)


@pytest.mark.parametrize("form", ["dense", "folded", "healing"])
def test_apply_w_matches_jax(form):
    rng = _rng(2)
    x = rng.standard_normal((2, 7, 96), dtype=np.float32)
    if form == "dense":
        w = rng.standard_normal((96, 80), dtype=np.float32)
    elif form == "folded":
        w = {"CU": rng.standard_normal((96, 16), dtype=np.float32),
             "R": rng.standard_normal((16, 80), dtype=np.float32)}
    else:
        w = {"C": rng.standard_normal((96, 16), dtype=np.float32),
             "U0": rng.standard_normal((16, 16), dtype=np.float32),
             "dU": rng.standard_normal((16, 16), dtype=np.float32) * 0.1,
             "R": rng.standard_normal((16, 80), dtype=np.float32)}
    yj = jl.apply_w(jnp.asarray(x), jax.tree.map(jnp.asarray, w))
    yt = tl.apply_w(torch.from_numpy(x), bridge.to_torch(w, "cpu"))
    assert tuple(yt.shape) == (2, 7, 80)
    assert_close(yt.numpy(), yj)


def test_apply_w_forced_cur_op_matches_chain():
    """The fused op (its plain version on CPU) agrees with apply_w's
    two-product chain; the gate picks the op only for CUDA activations at
    the JAX package's shape thresholds and M >= 32."""
    rng = _rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 7, 96), dtype=np.float32))
    w = {"CU": torch.from_numpy(rng.standard_normal((96, 16),
                                                    dtype=np.float32)),
         "R": torch.from_numpy(rng.standard_normal((16, 80),
                                                   dtype=np.float32))}
    y1 = cur_matmul_op(x, w["CU"], w["R"])
    y0 = tl.apply_w(x, w)
    assert tuple(y1.shape) == (2, 7, 80)
    assert_close(y1.numpy(), y0.numpy())
    assert not tl.use_cur_kernel(256, 64, 512, M=1024, on_cuda=False)
    assert tl.use_cur_kernel(256, 64, 512, M=1024, on_cuda=True)
    assert tl.use_cur_kernel(256, 64, 512, on_cuda=True)
    assert not tl.use_cur_kernel(256, 64, 512, M=31, on_cuda=True)
    assert tl.use_cur_kernel(256, 64, 512, M=32, on_cuda=True)
    assert not tl.use_cur_kernel(96, 16, 80, M=1024, on_cuda=True)


def _attn_inputs(B, S, K, G, d, seed):
    rng = _rng(seed)
    q = rng.standard_normal((B, S, K, G, d), dtype=np.float32)
    k = rng.standard_normal((B, S, K, d), dtype=np.float32)
    v = rng.standard_normal((B, S, K, d), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return ([jnp.asarray(a) for a in (q, k, v, pos)],
            [torch.from_numpy(a) for a in (q, k, v, pos)])


@pytest.mark.parametrize("path,window", [
    ("dense", 0), ("dense", 24), ("flash", 0), ("banded", 24)])
def test_attention_paths_match_jax(path, window):
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _attn_inputs(2, 64, 2, 2, 16, 4)
    if path == "dense":
        yj = jax_xla.dense_attn(jq, jk, jv, jp, jp, window, 0.25)
        yt = t_xla.dense_attn(tq, tk, tv, tp, tp, window, 0.25)
    elif path == "flash":
        yj = jax_xla.flash_attn(jq, jk, jv, jp, jp, 0.25, 16)
        yt = t_xla.flash_attn(tq, tk, tv, tp, tp, 0.25, 16)
    else:
        yj = jax_xla.banded_attn(jq, jk, jv, jp, jp, window, 0.25, 16)
        yt = t_xla.banded_attn(tq, tk, tv, tp, tp, window, 0.25, 16)
    assert_close(yt.numpy(), yj)


def test_registry_resolution_order():
    assert treg.resolve("mix", seq_len=512, on_cuda=True).name == \
        "flash_cuda"
    assert treg.resolve("mix", seq_len=512, window=64,
                        on_cuda=True).name == "flash_cuda"
    assert treg.resolve("mix", seq_len=512).name == "dense"
    assert treg.resolve("mix", seq_len=4096, window=64).name == "banded"
    assert treg.resolve("mix", seq_len=4096).name == "flash"


@pytest.mark.parametrize("window", [0, 24])
def test_registry_kernel_layout_matches_dense(window):
    """The kernel backend's (B,S,K,G,d) -> (B,H,S,d) transposes, run
    through the op's plain version, agree with the dense path."""
    _, (tq, tk, tv, tp) = _attn_inputs(2, 64, 2, 2, 16, 5)
    kernel_be = treg.resolve("mix", seq_len=64, window=window, on_cuda=True)
    dense_be = treg.resolve("mix", seq_len=64, window=window)
    assert (kernel_be.name, dense_be.name) == ("flash_cuda", "dense")
    yk = kernel_be.fn(tq, tk, tv, tp, tp, window, 0.25, chunk=16)
    yd = dense_be.fn(tq, tk, tv, tp, tp, window, 0.25, chunk=16)
    assert_close(yk.numpy(), yd.numpy())


def _model_case(which, tiny_cfg, tiny_params):
    if which == "smoke":
        jcfg = jax_get_smoke("llama3.1-8b")
        jparams = jax_init_params(jax.random.PRNGKey(3), jcfg)
    else:
        jcfg, jparams = tiny_cfg, tiny_params
    rng = _rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long()}
    return jcfg, jparams, port_cfg(jcfg), port_params(jparams), jbatch, \
        tbatch


@pytest.mark.parametrize("which", ["smoke", "tiny"])
def test_forward_matches_jax(which, tiny_cfg, tiny_params):
    jcfg, jp, tcfg, tp, jb, tb = _model_case(which, tiny_cfg, tiny_params)
    assert_close(forward(tp, tcfg, tb).numpy(), jax_forward(jp, jcfg, jb))


@pytest.mark.parametrize("which", ["smoke", "tiny"])
def test_forward_hidden_matches_jax(which, tiny_cfg, tiny_params):
    jcfg, jp, tcfg, tp, jb, tb = _model_case(which, tiny_cfg, tiny_params)
    lj, hj = jax_forward_hidden(jp, jcfg, jb)
    lt, ht = forward_hidden(tp, tcfg, tb)
    assert tuple(ht.shape) == hj.shape == (jcfg.n_layers + 1, 2, 24,
                                           jcfg.d_model)
    assert_close(ht.numpy(), hj)
    assert_close(lt.numpy(), lj)


@pytest.mark.parametrize("which", ["smoke", "tiny"])
def test_loss_fn_matches_jax(which, tiny_cfg, tiny_params):
    jcfg, jp, tcfg, tp, jb, tb = _model_case(which, tiny_cfg, tiny_params)
    lj = float(jax_loss_fn(jp, jcfg, jb))
    lt = float(loss_fn(tp, tcfg, tb))
    assert abs(lt - lj) / abs(lj) < 2e-5
    mask = np.zeros((2, 24), np.float32)
    mask[:, :10] = 1.0
    jb["mask"], tb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    lj = float(jax_loss_fn(jp, jcfg, jb))
    lt = float(loss_fn(tp, tcfg, tb))
    assert abs(lt - lj) / abs(lj) < 2e-5


def test_bridge_round_trip_keeps_bf16(tiny_params):
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tiny_params)
    tp = port_params(jp)
    assert tp["embed"].dtype == torch.bfloat16
    back = bridge.to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    assert len(jax.tree.leaves(back)) == len(jax.tree.leaves(jp))
