"""The capture's reduction by the program's cur.* ranges
(``harness/stages.py``), on a made-up event list whose answer is worked
out by hand, beside ``Trace.summary()`` on the same events; and on a
real capture of the CURing cell's path on the CPU."""
from types import SimpleNamespace

import pytest
import torch

from _perfbench_helpers import smoke
from harness import stages
from harness.profile import Trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """What the reduction reads of one of the profiler's raw events."""

    def __init__(self, name, t0, t1, kind, corr=0):
        self._name, self._t0, self._t1, self._kind = name, t0, t1, kind
        self._corr = corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0

    def device_type(self):
        return CUDA if self._kind in ("kernel", "gpu_memcpy",
                                      "gpu_user_annotation") else CPU

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._corr


# nanoseconds; a kernel launched in cur.svd runs on into cur.deim's host
# range, one launched before any range runs outside them all, an
# operator in cur.deim shares the fold kernel's correlation id, and the
# device's annotation of cur.compress spans the whole range
EVENTS = [
    Ev("cur.compress", 0, 1000, "user_annotation"),
    Ev("cur.class", 100, 900, "user_annotation"),
    Ev("cur.svd", 100, 400, "user_annotation"),
    Ev("cur.deim", 400, 800, "user_annotation"),
    Ev("aten::linalg_solve", 420, 440, "cpu_op", corr=3),
    Ev("cur.fold", 920, 980, "user_annotation"),
    Ev("cudaLaunchKernel", -100, -95, "cuda_runtime", corr=5),
    Ev("cudaLaunchKernel", 50, 55, "cuda_runtime", corr=4),
    Ev("cudaLaunchKernel", 150, 155, "cuda_runtime", corr=1),
    Ev("cudaLaunchKernel", 420, 425, "cuda_runtime", corr=2),
    Ev("cuLaunchKernel", 950, 955, "cuda_runtime", corr=3),
    Ev("outside", -50, -10, "kernel", corr=5),
    Ev("distances", 60, 90, "kernel", corr=4),
    Ev("svd_column_rotate", 200, 500, "kernel", corr=1),
    Ev("getrf_pivot", 600, 650, "gpu_memcpy", corr=2),
    Ev("fold_gemm", 955, 970, "kernel", corr=3),
    Ev("cur.compress", 60, 970, "gpu_user_annotation", corr=9),
]


def test_kernels_go_to_the_innermost_range_of_their_launch():
    st = stages.reduce(EVENTS)
    got = {k: [s["n"]] + [round(s[f] * 1e9, 6) for f in
                          ("wall_s", "busy_s", "idle_s")]
           for k, s in st["spans"].items()}
    # n, host self time, busy device time, idle device time within
    assert got == {"cur.compress": [1, 140, 30, 1000 - 395],
                   "cur.class": [1, 100, 0, 800 - 350],
                   "cur.svd": [1, 300, 300, 100],
                   "cur.deim": [1, 400, 50, 250],
                   "cur.fold": [1, 60, 15, 45]}
    assert st["cover"] == pytest.approx(395 / 435)


def test_summary_and_reduction_read_the_same_device_time():
    tr = Trace()
    tr.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: EVENTS)))
    tr.wall_s = 1.2e-6
    s = tr.summary()
    assert s["busy_s"] == pytest.approx(435e-9)
    assert s["window_s"] == 1.2e-6
    assert [n for n, _ in s["device_ops"]] == [
        "svd_column_rotate", "getrf_pivot", "outside", "distances",
        "fold_gemm"]
    assert len(s["idle_gaps"]) == 4
    no_ranges = [e for e in EVENTS if not e.name().startswith("cur.")]
    assert stages.reduce(no_ranges) == {"spans": {}, "cover": 0.0}


def test_a_cpu_capture_of_the_cell_path_has_every_range():
    from harness import cure
    cell, spec, mix = smoke("deepseek67b-stage.cure")
    c = cure.Cell(cell, spec, mix, 5, torch.device("cpu"))
    c.setup(warm=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c._one(c.layers[0])
    st = stages.reduce(prof.profiler.kineto_results.events())
    n = {k: s["n"] for k, s in st["spans"].items()}
    k = n["cur.class"]
    assert n == {"cur.compress": 1, "cur.class": k, "cur.wanda": k,
                 "cur.svd": k, "cur.deim": k, "cur.link": k, "cur.error": k,
                 "cur.readback": k, "cur.fold": len(c.targets)}
    assert st["cover"] == 0.0
    assert all(s["busy_s"] == 0 and s["wall_s"] > 0
               for s in st["spans"].values())
