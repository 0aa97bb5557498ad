"""Shared by the benchmark's CPU tests: the harness on the path, a cell
at its small (``smoke``) sizes, and one run of it on the CPU."""
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import common  # noqa: E402

common.set_env()


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def smoke(cell_name: str):
    """(cell, config, mix) dicts of a cell at its small sizes."""
    cell = common.merged(common.load("cells", cell_name), True)
    spec = common.merged(common.load("configs", cell["config"]), True)
    mix = common.merged(common.load("traffic", cell["traffic"]), True)
    return cell, spec, mix


def run_smoke(cell_name: str, seed: int = 7, seconds: float = 2.0,
              device: str = "cpu", **cell_keys) -> dict:
    """One run of a cell at its small sizes on ``device``; ``cell_keys``
    override the cell's own (say, a higher ``rate``)."""
    import importlib
    import torch
    cell, spec, mix = smoke(cell_name)
    cell = dict(cell, **cell_keys)
    driver = importlib.import_module(f"harness.{cell['driver']}")
    return driver.run(cell, spec, mix, seed, seconds, False,
                      torch.device(device), time.perf_counter())
