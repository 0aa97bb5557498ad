"""The compression pipeline's cur.* spans (``core/compress.py``): on an
enabled tracer's lane and as ``torch.profiler`` ranges on the profiler's
clock, in both pipelines; nothing at all with no capture and no tracer."""
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import CURConfig
from repro_torch.core import calibrate, compress, compress_model
from repro_torch.models import init_params
from repro_torch.obs import NULL_CTX, NULL_TRACER, Tracer

torch.set_num_threads(1)

STAGES = ("cur.wanda", "cur.svd", "cur.deim", "cur.link", "cur.error",
          "cur.readback")
LAYERS = [1, 2]


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke("llama3.1-8b")
    params = init_params(0, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    calib = calibrate(params, cfg, [{"tokens": toks, "labels": toks}])
    return cfg, params, calib


def _ccfg(pipeline):
    return CURConfig(enabled=True, r_max=16, pipeline=pipeline, fold_u=True)


def _inside(a, b):
    return b[0] <= a[0] and a[1] <= b[1]


@pytest.mark.parametrize("pipeline,classes,k,tracer", [
    ("batched", 3, 2, Tracer), ("loop", 6, 1, Tracer),
    ("batched", 3, 2, None)], ids=["batched", "loop", "batched-untraced"])
def test_pipeline_emits_every_span_nested_on_both_clocks(model, pipeline,
                                                         classes, k, tracer):
    cfg, params, calib = model
    tracer = tracer and tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        compress_model(params, cfg, _ccfg(pipeline), calib, layers=LAYERS,
                       tracer=tracer)
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("cur.")]
    by = {}
    for r in ranges:
        by.setdefault(r[2], []).append(r)
    n = {name: len(v) for name, v in by.items()}
    assert n == {"cur.compress": 1, "cur.fold": 6, "cur.class": classes,
                 **{s: classes for s in STAGES}}
    top = by["cur.compress"][0]
    for r in by["cur.class"] + by["cur.fold"]:
        assert _inside(r, top)
    for s in STAGES:
        for r in by[s]:
            assert sum(_inside(r, c) for c in by["cur.class"]) == 1
    assert not any(_inside(f, c) for f in by["cur.fold"]
                   for c in by["cur.class"])
    if tracer is None:
        return
    spans = [s for s in tracer.spans if s["track"] == compress.TRACK]
    assert sorted(s["name"] for s in spans) == sorted(r[2] for r in ranges)
    assert len(spans) == len(tracer.spans)
    # the tracer's spans lie where the profiler's ranges do, on its clock
    doc = tracer.to_chrome_trace()
    base = doc["otherData"]["clock_anchor"]["unix_ns"]
    span = next(e for e in doc["traceEvents"]
                if e.get("name") == "cur.compress")
    assert span["tid"] == compress.TRACK
    assert abs(base + span["ts"] * 1e3 - top[0]) < 50e6
    attrs = {s["name"]: s["attrs"] for s in spans}
    assert attrs["cur.compress"] == {"layers": 2}
    assert attrs["cur.svd"] == {"method": "exact", "route": "gram"}
    assert attrs["cur.deim"] == {"steps": 2 * 15}
    assert {(a["m"], a["n"], a["r"], a["k"]) for a in
            (s["attrs"] for s in spans if s["name"] == "cur.class")} == {
        (64, 64, 16, k), (64, 32, 16, k), (64, 160, 16, k)}


def test_no_capture_no_tracer_opens_no_range_and_adds_no_sync(model,
                                                              monkeypatch):
    cfg, params, calib = model
    ranges, syncs = [], []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: ranges.append(a))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    for pipeline in ("batched", "loop"):
        compress_model(params, cfg, _ccfg(pipeline), calib, layers=LAYERS)
    assert ranges == [] and syncs == []
    assert NULL_TRACER.spans == [] and NULL_TRACER.span("x") is NULL_CTX
