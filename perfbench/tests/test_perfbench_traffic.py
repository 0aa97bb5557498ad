"""A mix and a seed give a cell its inputs: the same seed the same
calibration rows and weights every time, another seed others; a CURing
mix gives the layer order."""
import pytest
import torch

from _perfbench_helpers import common, smoke
from harness import traffic

SEEDS = (3, 2 ** 31 + 77, 2 ** 40 + 5)
CURE = "deepseek67b-stage.cure"


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_stream(seed):
    a = traffic.rng_for(seed, 2).integers(0, 1000, 64)
    b = traffic.rng_for(seed, 2).integers(0, 1000, 64)
    assert (a == b).all()


def test_seeds_and_streams_differ():
    rows = [tuple(traffic.rng_for(s, k).integers(0, 10 ** 6, 8))
            for s in SEEDS + (-3,) for k in (0, 2)]
    assert len(set(rows)) == len(rows)


def test_weights_follow_the_seed():
    from harness.weights import make_params
    _, spec, _ = smoke(CURE)
    cfg = common.model_config(spec)
    spec = dict(spec, targets=common.cur_targets(spec))
    cpu = torch.device("cpu")
    a = make_params(cfg, spec, SEEDS[1], cpu)["groups"][0][0]
    b = make_params(cfg, spec, SEEDS[1], cpu)["groups"][0][0]
    c = make_params(cfg, spec, SEEDS[2], cpu)["groups"][0][0]
    for name in ("wq", "w_gate", "w_down"):
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name], c[name])


def test_cur_targets_are_full_rank_with_a_decaying_spectrum():
    from harness.weights import decaying
    g = torch.Generator().manual_seed(0)
    W = decaying((2, 64, 48), 4.0, 0.125, g, torch.float32,
                 torch.device("cpu"))
    s = torch.linalg.svdvals(W.double())
    assert (s[:, -1] > 1e-6 * s[:, 0]).all()          # rank min(m, n)
    assert (s[:, 8] < 0.5 * s[:, 0]).all()
    assert abs(float(W.std()) - 0.125) < 0.02


def test_cure_mix_cycles_through_the_layers():
    mix = common.load("traffic", "cure")
    it = traffic.layer_stream(mix, [9, 3, 5])
    assert [next(it) for _ in range(7)] == [3, 5, 9, 3, 5, 9, 3]
    with pytest.raises(ValueError):
        traffic.layer_stream(dict(mix, order="random"), [1])
