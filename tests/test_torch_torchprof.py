"""The port's profiler capture (``repro_torch.obs.torchprof``, the
counterpart of ``repro.obs.jaxprof``): span-keyed ``prof:<name>`` events
with memory snapshots, a Chrome trace per capture, and a no-op when it is
not asked for."""
import json

import torch

from repro_torch.obs import Tracer
from repro_torch.obs import torchprof
from repro_torch.obs.torchprof import TorchProfiler, device_memory_snapshot

torch.set_num_threads(1)


def test_device_memory_snapshot_is_empty_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_snapshot() == {}


def test_scope_emits_start_and_stop_events(tmp_path, monkeypatch):
    monkeypatch.setattr(torchprof, "device_memory_snapshot",
                        lambda: {"cuda:0": {"allocated_bytes.all.current":
                                            7}})
    tracer = Tracer()
    prof = TorchProfiler(str(tmp_path), tracer=tracer)
    with prof.scope("decode") as p:
        assert p is prof and prof.active
    assert not prof.active
    evs = [(e["name"], e["attrs"]["phase"]) for e in tracer.events]
    assert evs == [("prof:decode", "start"), ("prof:decode", "stop")]
    assert all(e["attrs"]["mem"]["cuda:0"]["allocated_bytes.all.current"]
               == 7 for e in tracer.events)


def test_cpu_capture_writes_a_chrome_trace(tmp_path):
    prof = TorchProfiler(str(tmp_path / "prof"), tracer=Tracer())
    for _ in range(2):
        with prof.scope("step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert [p.split("/")[-1] for p in prof.paths] == [
        "step.0.trace.json", "step.1.trace.json"]
    events = json.load(open(prof.paths[0]))["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_no_out_dir_is_a_no_op(tmp_path):
    tracer = Tracer()
    prof = TorchProfiler(None, tracer=tracer)
    assert not prof.start()
    with prof.scope("serve"):
        assert not prof.active
    prof.stop()
    assert prof.paths == [] and not prof.available
    # the events still key the (absent) capture to the obs trace
    assert [e["attrs"]["phase"] for e in tracer.events] == ["start", "stop"]
