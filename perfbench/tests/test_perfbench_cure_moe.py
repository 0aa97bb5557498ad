"""The MoE CURing cell (``harness/cure_moe.py``) on the CPU at its small
sizes: the reference agrees with the program, each fault planted where
the program handles experts (``tools/faults_moe.py``) fails its number,
the control (the reference in float8) fails every number, the cell's
configuration is the program's K-EXAONE cut to the stage, the new
per-layer reduction reads a made-up capture as worked out by hand, and a
program without K-EXAONE exits at once."""
import pytest
import torch

from _perfbench_helpers import common, run_smoke, smoke
from harness import cure_moe
from tools.faults import Patch
from tools.faults_moe import FAULTS

CELL = "kexaone236b-stage.cure"


def test_reference_agrees_with_the_port():
    res = run_smoke(CELL, seed=61, seconds=1.0)
    assert res["correct"], res["checks"]
    for name in cure_moe.NUMBERS:
        assert res["checks"][name]["value"] < 1e-4, res["checks"]
    # wq, wk, the shared expert and 4 experts in each of 2 layers
    assert res["weights_checked"] == 2 * 7
    assert res["e2e"]["cure_layer_s"] > 0


@pytest.mark.parametrize("name", list(FAULTS))
def test_a_fault_in_the_expert_path_fails_the_check(monkeypatch, name):
    plant, number = FAULTS[name]
    plant(monkeypatch.setattr)
    res = run_smoke(CELL, seed=62, seconds=0.5)
    assert not res["correct"], res["checks"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_control_fails_every_number():
    cell, spec, mix = smoke(CELL)
    lim = cell["limits"]
    for seed in (1, 2, 3):
        c = cure_moe.Cell(cell, spec, mix, seed, torch.device("cpu"))
        c.setup(warm=False)
        c.run_window(0.0, False)
        g = cure_moe.stage_gaps(c, "fp8")
        for name in cure_moe.NUMBERS:
            assert g[name] > lim[name], (name, g)


def test_followed_experts_are_drawn_from_the_seed():
    cell, spec, mix = smoke(CELL)
    res = run_smoke(CELL, seed=63, seconds=0.5, follow_experts=2)
    assert res["correct"], res["checks"]
    c = cure_moe.Cell(dict(cell, follow_experts=2), spec, mix, 63,
                      torch.device("cpu"))
    c.setup(warm=False)
    c.run_window(0.5, False)
    E = c.cfg.n_local_experts
    for li in c.layers:
        for last in (False, True):
            keys = c.followed(li, last)
            experts = [e for _, e in keys if e is not None]
            assert len(experts) == (E if last else 2)
            assert ("wq", None) in keys and ("shared.w_gate", None) in keys
        assert c.followed(li, False) == c.followed(li, False)
    # only the last layer CURed keeps every weight's selection; another
    # layer's records are copies, which hold no class's stack
    last = c.window["spans"][-1][0]
    for li, (_, _, recs, _) in c.window["done"].items():
        assert len(recs) == (3 + E if li == last else 3 + 2)
        if li != last:
            for rec in recs.values():
                S = rec["S"]
                assert S.untyped_storage().nbytes() == S.nbytes


def test_cell_config_is_the_program_s_cut_to_the_stage():
    """At full size the cell's ModelConfig is the registered K-EXAONE with
    16 layers and experts 0-31 held."""
    from repro_torch.configs import get_config
    spec = common.merged(common.load("configs", smoke(CELL)[0]["config"]),
                         False)
    cfg = cure_moe.model_config(spec)
    full = get_config("k-exaone-236b-a23b")
    assert cfg.blocks == full.blocks[:16]
    cut = full.replace(name=cfg.name, n_layers=16, groups=cfg.groups,
                       experts_held=32, scan_layers=False, remat=False)
    assert cfg == cut
    # 22.7 B parameters, 45.5 GB in bf16
    assert round(cfg.param_count() / 1e8) == 227


def test_a_program_without_k_exaone_exits_with_2(monkeypatch):
    from repro_torch.configs import base

    def old(**kw):
        raise TypeError("unexpected keyword argument 'moe_scoring'")
    monkeypatch.setattr(base, "ModelConfig", old)
    spec = smoke(CELL)[1]
    with pytest.raises(SystemExit) as e:
        cure_moe.model_config(spec)
    assert e.value.code == 2


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
        return (torch.autograd.DeviceType.CUDA
                if self._kind in ("kernel", "gpu_user_annotation")
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._corr


def test_expert_busy_time_counts_launches_inside_the_range():
    """Kernels launched inside ``cur.experts`` (at any depth) count, with
    their overlap merged; one launched outside does not, even where it
    runs inside; the device's annotation is left out."""
    events = [
        Ev("cur.experts", 100, 500, "user_annotation"),
        Ev("cur.svd", 150, 300, "user_annotation"),
        Ev("cudaLaunchKernel", 120, 125, "cuda_runtime", corr=1),
        Ev("cudaLaunchKernel", 200, 205, "cuda_runtime", corr=2),
        Ev("cudaLaunchKernel", 50, 55, "cuda_runtime", corr=3),
        Ev("k1", 130, 230, "kernel", corr=1),
        Ev("k2", 210, 400, "kernel", corr=2),
        Ev("k3", 420, 460, "kernel", corr=3),
        Ev("cur.experts", 100, 500, "gpu_user_annotation", corr=9),
    ]
    assert cure_moe.range_busy(events, "cur.experts") == pytest.approx(
        270e-9)
    assert cure_moe.range_busy(events[2:], "cur.experts") == 0.0


def test_expert_metric_reads_none_without_the_reduction():
    import run as runmod
    mod = runmod.reader("cure_expert_ms.cure")
    tr = {"busy_s": 2.0, "window_s": 4.0}
    assert mod.read({"trace": tr, "traced_layers": 1}) is None
    assert mod.read({"trace": dict(tr, expert_busy_s=1.5),
                     "traced_layers": 2}) == pytest.approx(750.0)


def test_a_cpu_capture_has_the_expert_ranges():
    """On the CPU the program opens one ``cur.experts`` range a layer,
    around the class of the shared expert and the 4 held experts."""
    from harness import stages
    cell, spec, mix = smoke(CELL)
    c = cure_moe.Cell(cell, spec, mix, 5, torch.device("cpu"))
    c.setup(warm=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c._one(c.layers[0])
    st = stages.reduce(prof.profiler.kineto_results.events())
    assert st["spans"]["cur.experts"]["n"] == 1
    # wq; wk (64 x 32 here) in the class of the experts
    assert st["spans"]["cur.class"]["n"] == 2
    assert st["spans"]["cur.fold"]["n"] == 4      # one a target


def test_patch_undoes_a_fault():
    from repro_torch.models import moe
    before = moe.route_cfg
    p = Patch()
    FAULTS["gate_scale_dropped"][0](p)
    assert moe.route_cfg is not before
    p.undo()
    assert moe.route_cfg is before


def test_routing_gap_reads_the_gate_matrices():
    """The program's routing against the reference router's on the same
    rows: 0 where they agree; a gate scaled by half reads 0.5 in the
    relative difference of the gate matrices, and moves no expert set."""
    cell, spec, mix = smoke(CELL)
    c = cure_moe.Cell(cell, spec, mix, 7, torch.device("cpu"))
    c.setup(warm=False)
    g = c.routing_gaps()
    assert g["routing_gap"] == 0.0 and g["routing_rows_differ"] == 0.0
    assert g["routing_gap_fp8"] > cell["limits"]["routing_gap"]
    from repro_torch.models import moe
    route = moe.route_cfg

    def halved(xt, router, cfg):
        gates, experts = route(xt, router, cfg)
        return gates * 0.5, experts
    p = Patch()
    p(moe, "route_cfg", halved)
    try:
        c.setup(warm=False)
    finally:
        p.undo()
    g = c.routing_gaps()
    assert g["routing_gap"] == pytest.approx(0.5, rel=1e-5)
    assert g["routing_rows_differ"] == 0.0

