"""Where a CURing cell's layer time goes, stage by stage of the program's
compression. The cell is set up as a run sets it up; then ``--layers``
layers, in the mix's order, are compressed through the timed path, each
under the profiler as a ``--trace 1`` run's traced layer is. Each
capture is reduced as that run reduces it (``harness/profile.py``) and
by the program's ``cur.*`` ranges (``harness/stages.py``). Prints one
JSON line a layer: the traced layer's wall and device busy seconds, the
per-stage table, the attributed share of busy time, and what the
device's ``gpu_user_annotation`` ranges are (left out of busy time).

    python3 perfbench/tools/stages.py --workload deepseek67b-stage.cure \\
        --seed 12345 --layers 3
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import common  # noqa: E402


def read_layer(c, li: int) -> dict:
    """One layer compressed under the profiler, its capture reduced."""
    import torch
    from harness import stages
    from harness.profile import Trace
    cuda = torch.autograd.DeviceType.CUDA
    with Trace() as tr:
        c._one(li)
    events = tr.prof.profiler.kineto_results.events()
    summary = tr.summary()
    # the device's copies of the ranges (``gpu_user_annotation``)
    ann = [e for e in events
           if e.device_type() == cuda and e.name().startswith("cur.")]
    return {"layer": li, "window_s": summary["window_s"],
            "busy_s": summary["busy_s"],
            "idle_share": 1.0 - summary["busy_s"] / summary["window_s"],
            "stages": stages.reduce(events),
            "gpu_user_annotation": {
                "n": len(ann),
                "flagged": sum(e.is_user_annotation() for e in ann)},
            "device_ops": summary["device_ops"],
            "idle_gaps": summary["idle_gaps"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--layers", type=int, default=1)
    args = ap.parse_args()
    common.set_env()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    from harness import cure, traffic
    cell = common.load("cells", args.workload)
    spec = common.merged(common.load("configs", cell["config"]), False)
    mix = common.load("traffic", cell["traffic"])
    c = cure.Cell(cell, spec, mix, args.seed, torch.device("cuda:0"))
    c.setup()
    order = traffic.layer_stream(mix, c.layers)
    c.rec.install()
    try:
        for _ in range(args.layers):
            out = read_layer(c, next(order))
            out["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(out), flush=True)
    finally:
        c.rec.uninstall()
    return 0


if __name__ == "__main__":
    sys.exit(main())
