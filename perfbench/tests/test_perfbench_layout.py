"""The benchmark's files are found by name: every cell, configuration,
traffic mix and metric that BENCHMARK.json names loads, and the file
keeps to the contract's shape."""
import importlib.util
import re

import pytest

from _perfbench_helpers import BENCH, ROOT, benchmark, common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
B = benchmark()


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "perfbench/run.py"]
    assert B["paths"] == ["perfbench"]
    assert 1 <= B["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in B[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_config_loads(cfg):
    spec = common.load("configs", cfg["name"])
    assert (ROOT / cfg["file"]).is_file()
    assert spec["source"] == cfg["source"]
    assert spec["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert key in spec["published"]
    model = common.model_config(common.merged(spec, False))
    assert model.n_layers == spec["num_hidden_layers"]


@pytest.mark.parametrize("wl", B["workloads"], ids=lambda w: w["name"])
def test_cell_loads(wl):
    cell = common.load("cells", wl["name"])
    assert cell["config"] == wl["config"]
    assert cell["traffic"] == wl["traffic"]
    assert cell["chips"] == wl["chips"] == 1
    common.load("traffic", wl["traffic"])
    assert (BENCH / "harness" / f"{cell['driver']}.py").is_file()
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for name in cell["end_to_end"]:
        m = e2e[name]
        assert "workloads" not in m or wl["name"] in m["workloads"]
    listed = [m["name"] for m in B["end_to_end"]
              if wl["name"] in m.get("workloads", [wl["name"]])]
    assert sorted(listed) == sorted(cell["end_to_end"])
    per = [m["name"] for m in B["per_layer"]
           if wl["name"] in m.get("workloads", [])]
    assert sorted(per) == sorted(cell["per_layer"])


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    path = BENCH / "metrics" / f"{m['name']}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.UNIT == m["unit"]
    assert callable(mod.read)
    assert m["moves"] in {e["name"] for e in B["end_to_end"]}
