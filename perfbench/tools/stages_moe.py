"""Where the MoE CURing cell's layer time goes (``tools/stages.py`` for
``harness/cure_moe.py``): the cell set up as a run sets it up, then
``--layers`` layers compressed in the mix's order, each under the
profiler as a ``--trace 1`` run's traced layer is, and reduced by stage
(``harness/stages.py``) and to the busy time launched inside the
``cur.experts`` ranges (``cure_expert_ms.cure``'s reduction). Prints one
JSON line a layer.

    python3 perfbench/tools/stages_moe.py \\
        --workload kexaone236b-stage.cure --seed 12345 --layers 2
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import common  # noqa: E402


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
    from harness import cure_moe, stages, traffic
    from harness.profile import Trace
    cell = common.load("cells", args.workload)
    spec = common.merged(common.load("configs", cell["config"]), False)
    mix = common.load("traffic", cell["traffic"])
    c = cure_moe.Cell(cell, spec, mix, args.seed, torch.device("cuda:0"))
    c.setup()
    order = traffic.layer_stream(mix, c.layers)
    c.rec.install()
    try:
        for _ in range(args.layers):
            li = next(order)
            with Trace() as tr:
                c._one(li)
            events = tr.prof.profiler.kineto_results.events()
            s = tr.summary()
            print(json.dumps({
                "layer": li, "window_s": s["window_s"],
                "busy_s": s["busy_s"],
                "idle_share": 1.0 - s["busy_s"] / s["window_s"],
                "expert_busy_s": cure_moe.range_busy(events, "cur.experts"),
                "stages": stages.reduce(events),
                "device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"],
                "device": torch.cuda.get_device_name(0)}), flush=True)
    finally:
        c.rec.uninstall()
    return 0


if __name__ == "__main__":
    sys.exit(main())
