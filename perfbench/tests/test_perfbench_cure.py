"""The CURing cell on the CPU at its small sizes: the reference agrees with
the program, and each fault planted in the program's compression turns
``correct`` false, as does the control (the reference in float8)."""
import pytest
import torch

from _perfbench_helpers import run_smoke, smoke
from tools.faults import FAULTS

CURE = "deepseek67b-stage.cure"


def test_reference_agrees_with_the_port():
    res = run_smoke(CURE, seed=61, seconds=1.0)
    assert res["correct"], res["checks"]
    for name in ("wanda_gap", "svd_gap", "deim_gap", "fold_gap"):
        assert res["checks"][name]["value"] < 1e-4, res["checks"]
    assert res["e2e"]["cure_layer_s"] > 0


@pytest.mark.parametrize("name", list(FAULTS))
def test_a_fault_in_the_compression_fails_the_check(monkeypatch, name):
    plant, number = FAULTS[name]
    plant(monkeypatch.setattr)
    res = run_smoke(CURE, seed=62, seconds=1.0)
    assert not res["correct"], res["checks"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_control_fails_every_stage():
    from harness import cure
    cell, spec, mix = smoke(CURE)
    lim = cell["limits"]
    for seed in (1, 2, 3):
        c = cure.Cell(cell, spec, mix, seed, torch.device("cpu"))
        c.setup(warm=False)
        c.run_window(0.0, False)
        g = cure.stage_gaps(c, "fp8")
        for name in cure.NUMBERS:
            assert g[name] > lim[name], (name, g)
