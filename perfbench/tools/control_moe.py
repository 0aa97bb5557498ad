"""Read the MoE CURing cell's check on several seeds (``tools/control.py``
for ``harness/cure_moe.py``): the program's numbers, the control's, and
those of planted faults (``tools/faults_moe.py``). For each seed the cell
is set up as a run sets it up (without the warm layer), one layer is
compressed through the timed path, and the check reads every weight of
it; on the ``--control-seeds`` the control (the reference, a stage at a
time in float8) is read on the same weights, and on the
``--fault-seeds`` each ``--faults`` fault is planted, the cell set up
again (a fault may act in calibration) and the same layer compressed
and read. Prints one JSON line a seed.

    python3 perfbench/tools/control_moe.py \\
        --workload kexaone236b-stage.cure --seeds 11,12,13 \\
        --control-seeds 11 --faults gate_scale_dropped --fault-seeds 12

``--smoke`` runs the configuration's and the cell's small sizes.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import common  # noqa: E402
from tools.control import _ints  # noqa: E402


def read_seed(cell, spec, mix, seed, device, control, faults) -> dict:
    """One seed's readings."""
    from harness import cure_moe
    from tools.faults import Patch
    from tools.faults_moe import FAULTS

    def cell_run():
        c = cure_moe.Cell(cell, spec, mix, seed, device)
        c.setup(warm=False)
        c.run_window(0.0, False)
        return c
    c = cell_run()
    out = {"seed": seed, "layers": c.layers,
           "program": cure_moe.stage_gaps(c)}
    if control:
        out["control"] = cure_moe.stage_gaps(c, "fp8")
    del c
    for name in faults:
        patch = Patch()
        FAULTS[name][0](patch)
        try:
            out["fault." + name] = cure_moe.stage_gaps(cell_run())
        finally:
            patch.undo()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    common.set_env()
    import torch
    smoke = args.smoke
    cell = common.merged(common.load("cells", args.workload), smoke)
    spec = common.merged(common.load("configs", cell["config"]), smoke)
    mix = common.merged(common.load("traffic", cell["traffic"]), smoke)
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    if device.type == "cpu" and not smoke:
        print("full sizes need a CUDA device", file=sys.stderr)
        return 3
    control, fault_seeds = _ints(args.control_seeds), _ints(args.fault_seeds)
    faults = [f for f in args.faults.split(",") if f]
    for seed in _ints(args.seeds):
        t = time.perf_counter()
        out = read_seed(cell, spec, mix, seed, device, seed in control,
                        faults if seed in fault_seeds else [])
        out["seconds"] = time.perf_counter() - t
        if device.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
