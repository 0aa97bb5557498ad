"""The port's roofline cost model (``repro_torch.roofline.analysis``): the
H100's constants, the JAX package's formulas (equal to the JAX functions
once the constants are the same), and ``model_flops`` equal to JAX's for
the dense configs the port registers."""
import pytest

import repro.roofline.analysis as jroof
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.roofline import analysis as troof


def test_constants_are_the_h100s():
    assert troof.PEAK_FLOPS == 989e12
    assert troof.HBM_BW == 3.35e12
    assert not hasattr(troof, "ICI_BW")


@pytest.mark.parametrize("m,n,r,batch,db", [
    (4096, 4096, 256, 1, 2), (4096, 14336, 16, 8, 2),
    (4096, 1024, 128, 2048, 2), (64, 160, 8, 1, 4), (2048, 8192, 64, 512, 4)])
def test_latency_formulas_match_jax_at_jax_constants(monkeypatch, m, n, r,
                                                     batch, db):
    monkeypatch.setattr(troof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BW", jroof.HBM_BW)
    assert troof.gemm_latency_s(m, n, dtype_bytes=db, batch=batch) == \
        jroof.gemm_latency_s(m, n, dtype_bytes=db, batch=batch)
    for folded in (True, False):
        assert troof.cur_latency_s(m, n, r, dtype_bytes=db, batch=batch,
                                   folded=folded) == \
            jroof.cur_latency_s(m, n, r, dtype_bytes=db, batch=batch,
                                folded=folded)


def test_h100_latency_is_the_max_of_bytes_and_flops():
    # decode (batch 1): weight bytes over 3.35 TB/s
    assert troof.gemm_latency_s(4096, 4096) == 4096 * 4096 * 2 / 3.35e12
    # a large batch: FLOPs over 989 TFLOP/s
    assert troof.gemm_latency_s(4096, 4096, batch=65536) == \
        2.0 * 65536 * 4096 * 4096 / 989e12
    folded = troof.cur_latency_s(4096, 14336, 256)
    assert folded == 4096 * 256 * 2 / 3.35e12 + 256 * 14336 * 2 / 3.35e12
    assert troof.cur_latency_s(4096, 14336, 256, folded=False) == (
        4096 * 256 * 2 / 3.35e12 + 256 * 256 * 2 / 3.35e12
        + 256 * 14336 * 2 / 3.35e12)


@pytest.mark.parametrize("arch", ["llama3.1-8b", "olmo-1b"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_flops_match_jax(arch, shape):
    t = troof.model_flops(get_config(arch), SHAPES[shape])
    j = jroof.model_flops(jax_get_config(arch), JAX_SHAPES[shape])
    assert t == j > 0
    n = get_config(arch).active_param_count()
    if SHAPES[shape].kind == "decode":
        assert t == 2.0 * n * SHAPES[shape].global_batch


def test_shapes_match_jax():
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for k, s in SHAPES.items():
        j = JAX_SHAPES[k]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
