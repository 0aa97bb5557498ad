"""A run of a cell, end to end on the CPU at the cells' small sizes: the
last line's keys, the refusal without a card or without the program, a
stall that the metric sees, the control tool, and no JAX on the card
path."""
import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest
import torch

from _perfbench_helpers import BENCH, ROOT, run_smoke, smoke

CURE = "deepseek67b-stage.cure"
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_last_line_has_only_the_contract_keys():
    import run as runmod
    cell, _, _ = smoke(CURE)
    res = run_smoke(CURE, seconds=0.5)
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 1}
    line = runmod.result_line(cell, res, False, dev)
    assert set(line) == KEYS
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == set(cell["end_to_end"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    res["trace"] = {"busy_s": 1.0, "window_s": 2.0,
                    "device_ops": [["k", 1.0]], "idle_gaps": [["g", 0.5]]}
    res["data"] = dict(res["data"], trace=res["trace"], traced_layers=1)
    line = runmod.result_line(cell, res, True, dev)
    assert set(line) == KEYS | {"breakdown"}
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == set(cell["per_layer"])
    json.dumps(line)


def test_no_card_no_result():
    import run as runmod
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = runmod.main(["--workload", CURE, "--seed", "1", "--seconds",
                          "1", "--trace", "0"])
    assert rc != 0 and buf.getvalue() == ""


def test_checkout_without_the_program_gives_no_result(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CURE, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=tmp_path, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": ""}, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_a_stall_moves_the_layer_time(monkeypatch):
    from repro_torch import core
    base = run_smoke(CURE, seed=22, seconds=1.0)["e2e"]
    compress_model = core.compress_model

    def slow(*a, **k):
        time.sleep(0.2)
        return compress_model(*a, **k)
    monkeypatch.setattr(core, "compress_model", slow)
    stalled = run_smoke(CURE, seed=22, seconds=1.0)["e2e"]
    assert stalled["cure_layer_s"] > base["cure_layer_s"] + 0.1


def test_control_tool_reads_program_control_and_fault():
    """The tool at the small sizes: the program reads rounding, the
    control and the planted DEIM fault read above the cell's limits."""
    p = subprocess.run(
        [sys.executable, str(BENCH / "tools" / "control.py"), "--workload",
         CURE, "--seeds", "1,2", "--control-seeds", "1", "--faults",
         "deim_without_interpolation", "--fault-seeds", "2", "--smoke"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "PYTHONPATH": str(ROOT / "src")})
    assert p.returncode == 0, p.stderr[-2000:]
    rows = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    assert [r["seed"] for r in rows] == [1, 2]
    lim = smoke(CURE)[0]["limits"]
    for r in rows:
        assert all(r["program"][k] <= lim[k] for k in lim)
    assert rows[0]["control"]["fold_gap"] > lim["fold_gap"]
    assert rows[1]["fault.deim_without_interpolation"]["deim_gap"] > \
        lim["deim_gap"]


def test_the_card_path_loads_no_jax():
    """A CPU run of the cell and its check in a fresh process leaves no
    module whose top-level name is jax, jaxlib, flax or repro."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "from _perfbench_helpers import run_smoke, common\n"
        "import run\n"
        f"run_smoke({CURE!r}, seconds=0.5)\n"
        "from harness import profile, cure, weights\n"
        "from reference import model, cur\n"
        "print('FOUND', common.forbidden_loaded())\n")
    env = {k: v for k, v in os.environ.items()}
    env["PYTHONPATH"] = str(ROOT / "src")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=BENCH, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FOUND []" in p.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_small_cell_on_the_card_agrees_with_the_reference(card):
    res = run_smoke(CURE, seed=51, seconds=0.5, device="cuda")
    assert res["correct"], res["checks"]
