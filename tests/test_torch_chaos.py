"""The port's seeded chaos harness against the JAX package's: the same
activation draws, fault plans that load in either package, and each fault
class injected into the port's Server (llama SMOKE, f32, bridged params)
with the resilience invariants checked after: the pool drains back to
full, refcounts conserve, every original request's greedy tokens equal a
fault-free run's, the same plan replays the same fault events -- and the
port's event list and tokens equal the JAX Server's under the same plan
and workload."""
import contextlib
import io
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro.serving import PagedConfig as JaxPagedConfig
from repro.serving import Server as JaxServer
from repro.testing import ChaosEngine as JaxChaosEngine
from repro.testing import FaultPlan as JaxFaultPlan
from repro.testing.chaos import _fires as jax_fires
from repro_torch.launch import serve as tserve
from repro_torch.serving import (
    BlockAllocator, PagedConfig, ResilienceConfig, Server)
from repro_torch.testing import (
    ChaosEngine, FaultPlan, FaultSpec, corrupt_checkpoint)
from repro_torch.testing.chaos import FAULT_KINDS, _fires

from _torch_helpers import port_cfg, port_params

CALIB = np.random.RandomState(1).randint(0, 256, (2, 64)).astype(np.int32)

settings.register_profile("torch_chaos", deadline=None, max_examples=20)
settings.load_profile("torch_chaos")


# ---------------------------------------------------------------------------
# plans and activation draws
# ---------------------------------------------------------------------------

def test_fires_matches_jax():
    for seed in (0, 1, 17, 4093):
        for fi in range(4):
            for step in range(0, 60, 3):
                for p in (0.0, 0.1, 0.5, 0.9, 1.0):
                    assert _fires(seed, fi, step, p) == jax_fires(
                        seed, fi, step, p)


def test_unknown_fault_kind_raises():
    assert FAULT_KINDS == ("latency_spike", "transient_error",
                           "pool_squeeze", "queue_storm",
                           "checkpoint_corruption")
    with pytest.raises(ValueError):
        FaultSpec("cosmic_ray")


def test_fault_plan_json_crosses_packages(tmp_path):
    plan = FaultPlan([FaultSpec("latency_spike", start_step=2, end_step=9,
                                probability=0.5, magnitude=0.01),
                      FaultSpec("queue_storm", n=4),
                      FaultSpec("transient_error", site="decode")], seed=17)
    path = plan.save(str(tmp_path / "port.json"))
    assert FaultPlan.load(path).to_json() == plan.to_json()
    assert JaxFaultPlan.load(path).to_json() == plan.to_json()
    jplan = JaxFaultPlan.from_json(plan.to_json())
    jpath = jplan.save(str(tmp_path / "jax.json"))
    assert FaultPlan.load(jpath).to_json() == jplan.to_json()
    assert open(path).read() == open(jpath).read()


@given(seed=st.integers(0, 10_000))
@settings(max_examples=5)
def test_random_plans_never_leak(seed):
    """Whatever a random squeeze plan does, chaos hands every squeezed
    block back (tests/test_chaos.py's sweep on the port's allocator)."""

    class _Fake:
        def __init__(self, alloc):
            self.scheduler = type("S", (), {"alloc": alloc})()

    rng = random.Random(seed)
    faults = [FaultSpec("pool_squeeze", start_step=rng.randrange(0, 10),
                        end_step=rng.randrange(10, 20),
                        magnitude=rng.choice([0.0, 0.3, 0.9]),
                        n=rng.randrange(1, 6))
              for _ in range(rng.randrange(1, 4))]
    alloc = BlockAllocator(16)
    fake = _Fake(alloc)
    ch = ChaosEngine(FaultPlan(faults, seed=seed))
    for step in range(25):
        ch.on_step(fake, step)
    ch.finish(fake)
    assert alloc.n_free == 16 and not alloc._ref


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_corrupt_checkpoint_changes_the_leaf(tmp_path, mode):
    d = tmp_path / "step_00000003"
    d.mkdir()
    leaf = d / "leaf_00000.npy"
    np.save(leaf, np.arange(64, dtype=np.float32))
    before = leaf.read_bytes()
    path = corrupt_checkpoint(str(tmp_path), 3, mode=mode, seed=2)
    assert path == str(leaf)
    after = leaf.read_bytes()
    if mode == "bitflip":
        diff = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
        assert len(after) == len(before) and len(diff) == 1
        assert before[diff[0]] ^ after[diff[0]] == 0x40
    else:
        assert after == before[:len(before) // 2]
    with pytest.raises(ValueError):
        corrupt_checkpoint(str(tmp_path), 3, mode="melt")


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_corrupt_checkpoint_on_a_real_manager_falls_back(tmp_path, mode):
    """The chaos fault against the port's own checkpoint manager: a
    corrupted newest step fails its crc32 and restore falls back to the
    previous one, past every corrupted step (tests/test_checkpoint.py's
    cases in the JAX package)."""
    import torch
    from repro_torch.dist import CheckpointManager
    mgr = CheckpointManager(str(tmp_path), keep_n=3)

    def tree(s):
        return {"w": torch.full((4, 8), float(s)),
                "step": torch.tensor(s, dtype=torch.int32)}

    for s in (1, 2, 3):
        mgr.save(s, tree(s))
    corrupt_checkpoint(str(tmp_path), 3, mode=mode, seed=4)
    assert mgr.latest_valid_step() == 2
    corrupt_checkpoint(str(tmp_path), 2, mode="bitflip")
    assert mgr.latest_valid_step() == 1
    step, restored = mgr.restore(tree(0), device="cpu")
    assert step == 1 and int(restored["step"]) == 1
    assert bool((restored["w"] == 1.0).all())


# ---------------------------------------------------------------------------
# fault classes against the port's Server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    jcfg = jax_get_smoke("llama3.1-8b")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, port_cfg(jcfg), port_params(jparams)


@pytest.fixture(scope="module")
def prompts(llama):
    rng = np.random.RandomState(0)
    return [rng.randint(0, llama[0].vocab_size, size=n).tolist()
            for n in (5, 9, 13, 7, 11)]


def _chaos_run(llama, prompts, plan, res=None, C=4, n_new=8, jax_server=False):
    jcfg, jparams, cfg, params = llama
    if jax_server:
        ch = JaxChaosEngine(JaxFaultPlan.from_json(plan.to_json())) \
            if plan is not None else None
        pc = JaxPagedConfig.sized_for(64, C)
        srv = JaxServer(jparams, jcfg, pc, max_concurrency=C, resilience=res,
                        chaos=ch, calib_tokens=jnp.asarray(CALIB))
    else:
        ch = ChaosEngine(plan) if plan is not None else None
        pc = PagedConfig.sized_for(64, C)
        srv = Server(params, cfg, pc, max_concurrency=C, resilience=res,
                     chaos=ch, calib_tokens=CALIB, device="cpu")
    rids = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    srv.drain()
    if ch is not None:
        ch.finish(srv)
        srv.drain()                 # finish anything a release unblocked
    return srv, pc, ch, rids


@pytest.fixture(scope="module")
def baseline(llama, prompts):
    srv, _pc, _ch, rids = _chaos_run(llama, prompts, plan=None)
    return {r: tuple(srv.finished[r].out_tokens) for r in rids}


def _assert_invariants(srv, pc, baseline, rids):
    assert srv.scheduler.alloc.n_free == pc.n_blocks   # pool drained
    assert not srv.scheduler.alloc._ref                # refcounts conserve
    srv.scheduler.alloc.assert_used(exactly=0)
    for r in rids:
        req = srv.finished[r]
        assert req.finish_reason in ("eos", "length"), req.finish_reason
        assert tuple(req.out_tokens) == baseline[r]    # bit-identical


def test_transient_prefill_error_rolls_back_bit_exact(llama, prompts,
                                                      baseline):
    plan = FaultPlan([FaultSpec("transient_error", start_step=1,
                                end_step=4, site="prefill")], seed=5)
    srv, pc, ch, rids = _chaos_run(llama, prompts, plan)
    _assert_invariants(srv, pc, baseline, rids)
    assert srv.stats()["step_faults"] >= 1
    assert all(e["kind"] == "transient_error" for e in ch.event_log())


def test_transient_decode_error_is_retried(llama, prompts, baseline):
    plan = FaultPlan([FaultSpec("transient_error", start_step=3,
                                end_step=20, probability=0.5,
                                site="decode")], seed=9)
    srv, pc, ch, rids = _chaos_run(llama, prompts, plan)
    _assert_invariants(srv, pc, baseline, rids)
    assert srv.stats()["step_faults"] == len(ch.events) > 0


def test_pool_squeeze_releases_and_recovers(llama, prompts, baseline):
    plan = FaultPlan([FaultSpec("pool_squeeze", start_step=2,
                                end_step=10, magnitude=0.5)], seed=7)
    srv, pc, ch, rids = _chaos_run(llama, prompts, plan)
    _assert_invariants(srv, pc, baseline, rids)
    assert {e["kind"] for e in ch.event_log()} == {"pool_squeeze"}


def test_queue_storm_bounded_admission_shields_originals(llama, prompts,
                                                         baseline):
    plan = FaultPlan([FaultSpec("queue_storm", start_step=2, end_step=4,
                                n=6)], seed=3)
    res = ResilienceConfig(max_queue=len(prompts))
    srv, pc, ch, rids = _chaos_run(llama, prompts, plan, res=res)
    _assert_invariants(srv, pc, baseline, rids)
    storm_rids = set(srv.finished) - set(rids)
    assert storm_rids
    rejected = [r for r in storm_rids
                if srv.finished[r].finish_reason == "rejected"]
    events = [e for e in ch.event_log() if e["kind"] == "queue_storm"]
    assert events and all(e["detail"]["offered"] == 6 for e in events)
    assert srv.stats()["failed"]["rejected"] == len(rejected)


_MULTI = FaultPlan([
    FaultSpec("latency_spike", start_step=2, end_step=5, probability=0.5,
              magnitude=0.001),
    FaultSpec("transient_error", start_step=1, end_step=10,
              probability=0.5),
    FaultSpec("pool_squeeze", start_step=4, end_step=9, magnitude=0.5),
    FaultSpec("queue_storm", start_step=5, end_step=6, n=3),
], seed=11)


def test_multi_fault_plan_replays_identically(llama, prompts, baseline):
    srv1, pc, ch1, rids = _chaos_run(llama, prompts, _MULTI)
    _assert_invariants(srv1, pc, baseline, rids)
    srv2, _pc, ch2, _rids = _chaos_run(
        llama, prompts, FaultPlan.from_json(_MULTI.to_json()))
    assert ch1.event_log() == ch2.event_log()
    assert ch1.event_log()


def test_chaos_events_and_tokens_match_jax(llama, prompts):
    """The same plan and workload on the JAX Server and the port's: the
    same fault events, step for step, and the same tokens and finish
    reasons for every request (storm requests included)."""
    tsrv, _, tch, _ = _chaos_run(llama, prompts, _MULTI)
    jsrv, _, jch, _ = _chaos_run(llama, prompts, _MULTI, jax_server=True)
    assert tch.event_log() == jch.event_log()
    assert {i: (r.out_tokens, r.finish_reason)
            for i, r in tsrv.finished.items()} == {
        i: (r.out_tokens, r.finish_reason) for i, r in jsrv.finished.items()}
    assert tsrv.stats()["step_faults"] == jsrv.stats()["step_faults"]


def test_spec_decode_under_chaos_keeps_tokens(llama, prompts, baseline):
    """A self-drafted speculative server under the multi-fault plan gives
    the fault-free greedy tokens and returns every block."""
    _, _, cfg, params = llama
    pc = PagedConfig.sized_for(64, 4)
    ch = ChaosEngine(FaultPlan.from_json(_MULTI.to_json()))
    srv = Server(params, cfg, pc, max_concurrency=4, calib_tokens=CALIB,
                 draft_params=params, spec_k=3, chaos=ch, device="cpu")
    rids = [srv.submit(p, max_new_tokens=8) for p in prompts]
    srv.drain()
    ch.finish(srv)
    srv.drain()
    _assert_invariants(srv, pc, baseline, rids)
    assert srv.stats()["n_spec_windows"] > 0 and ch.events


def test_serve_cli_chaos(tmp_path):
    plan = str(tmp_path / "plan.json")
    FaultPlan([FaultSpec("transient_error", start_step=1, end_step=6,
                         probability=0.5),
               FaultSpec("pool_squeeze", start_step=2, end_step=8,
                         magnitude=0.5)], seed=3).save(plan)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = tserve.main(["--arch", "llama3.1-8b", "--smoke",
                             "--n-requests", "5", "--new-tokens", "6",
                             "--device", "cpu", "--chaos", plan,
                             "--obs-out", str(tmp_path / "obs")])
    text = out.getvalue()
    assert "chaos: 2 fault streams (seed 3)" in text
    assert stats["completed"] == 5 and stats["step_faults"] > 0
    path = os.path.join(str(tmp_path / "obs"), "chaos_events.jsonl")
    events = [json.loads(line) for line in open(path)]
    assert {e["kind"] for e in events} == {"transient_error", "pool_squeeze"}
