"""The port's Server against the JAX package's on the serve CLI's
``make_workload``, with the same bridged params and calibration tokens
(llama SMOKE and REPRO, f32; dense pools and CUR-KV at r = hd and hd/2):
the same greedy tokens, finish reasons and preemption counts, across
multi-step decode windows, preemption/restore and EOS retirement."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_repro as jax_get_repro
from repro.configs import get_smoke as jax_get_smoke
from repro.launch.serve import make_workload as jax_make_workload
from repro.models import init_params as jax_init_params
from repro.serving import PagedConfig as JaxPagedConfig
from repro.serving import Server as JaxServer
from repro_torch.launch import serve as tserve
from repro_torch.serving import PagedConfig, Server

from _torch_helpers import port_cfg, port_params

torch.set_num_threads(1)

CALIB = np.random.RandomState(1).randint(0, 256, (2, 64)).astype(np.int32)


@pytest.fixture(scope="module", params=["smoke", "repro"])
def model(request):
    jcfg = (jax_get_smoke("llama3.1-8b") if request.param == "smoke"
            else jax_get_repro())
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, port_cfg(jcfg), port_params(jparams)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

def _serve(server_cls, params, cfg, pc, wl, calib, eos_id=None, **kw):
    srv = server_cls(params, cfg, pc, max_concurrency=4, calib_tokens=calib,
                     **kw)
    for w in wl:
        srv.submit(w["prompt"], w["max_new_tokens"], eos_id=eos_id)
    srv.drain()
    return srv


def _tokens(srv):
    return {k: (r.out_tokens, r.finish_reason)
            for k, r in srv.finished.items()}


@pytest.mark.parametrize("case", ["windows", "preempt", "eos"])
def test_server_greedy_tokens_match_jax(model, case):
    """Multi-step decode windows, a pool small enough to preempt and
    restore, and EOS retirement (single steps): the same greedy tokens,
    finish reasons and preemption count as the JAX Server."""
    jcfg, jparams, cfg, params = model
    hd = jcfg.resolved_head_dim
    wl = jax_make_workload(8, jcfg.vocab_size, max_new=12)
    assert wl == tserve.make_workload(8, jcfg.vocab_size, max_new=12)
    calib = CALIB % jcfg.vocab_size
    max_len = max(len(w["prompt"]) + w["max_new_tokens"] for w in wl)
    for cur_kv, r in ((False, 0), (True, hd), (True, hd // 2)):
        if case == "preempt":
            kw = dict(block_size=8, n_blocks=12, max_blocks_per_seq=7,
                      cur_kv=cur_kv, kv_rank=r)
            jpcfg, pc = JaxPagedConfig(**kw), PagedConfig(**kw)
        else:
            jpcfg = JaxPagedConfig.sized_for(max_len, 4, block_size=8,
                                             cur_kv=cur_kv, kv_rank=r)
            pc = PagedConfig.sized_for(max_len, 4, block_size=8,
                                       cur_kv=cur_kv, kv_rank=r)
        eos = None
        if case == "eos":      # a token request 0 emits early
            first = _serve(Server, params, cfg, pc, wl, calib, device="cpu")
            eos = first.finished[0].out_tokens[2]
        js = _serve(JaxServer, jparams, jcfg, jpcfg, wl, jnp.asarray(calib),
                    eos_id=eos)
        ts = _serve(Server, params, cfg, pc, wl, calib, eos_id=eos,
                    device="cpu")
        assert _tokens(ts) == _tokens(js)
        assert ts.scheduler.n_preemptions == js.scheduler.n_preemptions
        assert ts.scheduler.alloc.n_free == pc.n_blocks
        if case == "preempt":
            assert ts.scheduler.n_preemptions > 0
        if case == "eos":
            assert any(r.finish_reason == "eos"
                       for r in ts.finished.values())
        if case == "windows":
            # some engine step ran a multi-step window
            windows = ts.obs.snapshot()["repro_serving_decode_step_s"]
            assert windows["count"] < ts.n_decode_steps
            jst, tst = js.stats(), ts.stats()
            assert set(tst) == set(jst)
            for key in ("completed", "tokens_generated", "n_prefill_steps",
                        "n_decode_steps", "cache_bytes",
                        "gathered_bytes_per_step", "pool_blocks_total",
                        "reconstructed_bytes_per_prefill"):
                assert tst[key] == jst[key], key


def test_server_ports_no_speculation_or_chaos(model):
    """Without a draft (or with spec_k 0) and without a chaos engine the
    Server is the plain one: no draft pool, no speculative window, no
    fault, as in the JAX Server."""
    _, _, cfg, params = model
    wl = tserve.make_workload(4, cfg.vocab_size, max_new=6)
    for kw in ({}, {"spec_k": 4}, {"draft_params": params}):
        srv = Server(params, cfg, PagedConfig.sized_for(64, 4),
                     max_concurrency=4, device="cpu", **kw)
        assert srv.spec_k == 0 and srv.draft_cache is None
        assert srv.chaos is None
        for w in wl:
            srv.submit(w["prompt"], w["max_new_tokens"])
        srv.drain()
        st = srv.stats()
        assert st["completed"] == len(wl)
        assert st["n_spec_windows"] == st["n_spec_fallbacks"] == 0
        assert st["spec_accept_rate"] == 0.0 and st["step_faults"] == 0
