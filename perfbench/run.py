"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is ``perfbench/cells/<cell>.json``; it names its configuration
(``perfbench/configs/``), its traffic mix (``perfbench/traffic/``), its
driver (``perfbench/harness/<driver>.py``) and its metrics, end-to-end
(``--trace 0``) and per layer (``--trace 1``, each read by
``perfbench/metrics/<metric>.py``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number the check compared beside its limit (also the last lines of
standard error). Exits non-zero, printing no result, without as many
CUDA devices as the cell asks for, or with JAX or the JAX package loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import common  # noqa: E402


def reader(name: str):
    """``perfbench/metrics/<name>.py``: its ``UNIT`` and ``read(data)``."""
    path = common.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer(names, data) -> dict:
    out = {}
    for name in names:
        mod = reader(name)
        v = mod.read(data)
        if v is not None:
            out[name] = {"value": v, "unit": mod.UNIT}
    return out


def result_line(cell: dict, res: dict, trace: bool, device: dict) -> dict:
    """The last line; ``res`` is what the cell's driver returned (its
    end-to-end values under ``e2e``, their units under ``units``)."""
    e2e = res["e2e"]
    if trace:
        metrics = per_layer(cell["per_layer"], res["data"])
    else:
        metrics = {}
        for name in cell["end_to_end"]:
            if name == "setup_s":
                metrics[name] = {"value": res["setup_s"], "unit": "s"}
            else:
                metrics[name] = {"value": e2e[name],
                                 "unit": res["units"][name]}
    line = {"correct": bool(res["correct"]), "attempted": e2e["attempted"],
            "failed": e2e["failed"], "metrics": metrics, "device": device}
    tr = res.get("trace")
    if trace and tr:
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_env()
    try:
        cell = common.load("cells", args.workload)
    except FileNotFoundError:
        print(f"no cell {args.workload!r} under perfbench/cells",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    spec = common.merged(common.load("configs", cell["config"]), False)
    mix = common.load("traffic", cell["traffic"])
    driver = importlib.import_module(f"harness.{cell['driver']}")
    res = driver.run(cell, spec, mix, args.seed, args.seconds,
                     bool(args.trace), dev, T_START)
    found = common.forbidden_loaded()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    tr = res.get("trace")
    if args.trace:
        if not tr:
            print("the traced run captured no device trace", file=sys.stderr)
            return 5
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
    line = result_line(cell, res, bool(args.trace), device)
    print("launches: " + json.dumps(res["launches"]))
    print("info: " + json.dumps({k: res[k] for k in res if k not in (
        "e2e", "data", "checks", "launches", "trace", "correct", "units")}
        | {"e2e": res["e2e"]}))
    for name, c in res["checks"].items():
        print(f"check: {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
