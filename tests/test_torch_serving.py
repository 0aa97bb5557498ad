"""Parity of the paged serving path below the Server: the port's paged
prefill/decode, CUR-KV calibration and sampling against the JAX
package's, on the same bridged params and numpy tokens (llama SMOKE and
REPRO, f32), plus the host-side copies (loadgen, metrics) and the serve
CLI. Integer outputs (DEIM indices) must be equal; floats are held to
2e-5 scale-relative. The Server itself: tests/test_torch_server.py."""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_repro as jax_get_repro
from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro.obs import loadgen as jax_loadgen
from repro.obs.metrics import Registry as JaxRegistry
from repro.serving import PagedConfig as JaxPagedConfig
from repro.serving import paged_cache as jpc
from repro.serving import runtime as jrt
from repro.serving.sampling import _filtered_logits as jax_filtered
from repro_torch.launch import serve as tserve
from repro_torch.obs import loadgen
from repro_torch.obs.metrics import Registry
from repro_torch.serving import PagedConfig
from repro_torch.serving import paged_cache as tpc
from repro_torch.serving import runtime as trt
from repro_torch.serving.sampling import (
    _filtered_logits, greedy_tokens, request_generator, sample_tokens)

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)

CALIB = np.random.RandomState(1).randint(0, 256, (2, 64)).astype(np.int32)


@pytest.fixture(scope="module", params=["smoke", "repro"])
def model(request):
    jcfg = (jax_get_smoke("llama3.1-8b") if request.param == "smoke"
            else jax_get_repro())
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, port_cfg(jcfg), port_params(jparams)


def _pools(hd):
    """(cur_kv, kv_rank, prefill backend): dense, then CUR-KV at r = hd
    and hd/2 with the fold and the reconstruct backends."""
    return [(False, 0, "fold")] + [
        (True, r, be) for r in (hd, hd // 2)
        for be in ("fold", "reconstruct")]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def test_paged_prefill_decode_match_jax(model):
    jcfg, jparams, cfg, params = model
    hd = jcfg.resolved_head_dim
    calib = CALIB % jcfg.vocab_size
    lens = np.array([5, 11, 0, 17], np.int32)
    B, S = len(lens), 32
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    table = np.full((B, 4), -1, np.int32)
    table[0, :1], table[1, :2], table[3, :3] = [0], [1, 2], [3, 4, 5]
    for cur_kv, r, be in _pools(hd):
        kw = dict(block_size=8, n_blocks=8, max_blocks_per_seq=4,
                  cur_kv=cur_kv, kv_rank=r)
        jpcfg, pc = JaxPagedConfig(**kw), PagedConfig(**kw)
        jc = jrt.calibrate_kv(jparams, jcfg, jpcfg,
                              jpc.init_paged_cache(jcfg, jpcfg),
                              jnp.asarray(calib))
        tc = trt.calibrate_kv(params, cfg, pc,
                              tpc.init_paged_cache(cfg, pc, "cpu"),
                              torch.from_numpy(calib))
        jl, jc = jrt.paged_prefill(jparams, jcfg, jpcfg, jnp.asarray(toks),
                                   jnp.asarray(lens), jc, jnp.asarray(table),
                                   backend=be)
        tl, tc = trt.paged_prefill(params, cfg, pc, torch.from_numpy(toks),
                                   torch.from_numpy(lens), tc,
                                   torch.from_numpy(table), backend=be)
        assert_close(_np(tl), _np(jl))
        ctx, active = lens.copy(), lens > 0
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        for _ in range(2):
            jl, jc = jrt.paged_decode(jparams, jcfg, jpcfg, jnp.asarray(nxt),
                                      jc, jnp.asarray(table),
                                      jnp.asarray(ctx), jnp.asarray(active))
            tl, tc = trt.paged_decode(params, cfg, pc, torch.from_numpy(nxt),
                                      tc, torch.from_numpy(table),
                                      torch.from_numpy(ctx),
                                      torch.from_numpy(active))
            assert_close(_np(tl[active]), _np(jl)[active])
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            ctx = ctx + active
        for name in ("k", "v"):
            assert_close(_np(tc[name]), _np(jc[name]))


def test_calibrate_kv_matches_jax(model):
    jcfg, jparams, cfg, params = model
    hd = jcfg.resolved_head_dim
    calib = CALIB % jcfg.vocab_size
    for r in (hd, hd // 2):
        kw = dict(block_size=8, n_blocks=4, max_blocks_per_seq=2,
                  cur_kv=True, kv_rank=r)
        jpcfg, pc = JaxPagedConfig(**kw), PagedConfig(**kw)
        jp = jrt.calibrate_kv(jparams, jcfg, jpcfg,
                              jpc.init_paged_cache(jcfg, jpcfg),
                              jnp.asarray(calib))["proj"]
        tp = trt.calibrate_kv(params, cfg, pc,
                              tpc.init_paged_cache(cfg, pc, "cpu"),
                              torch.from_numpy(calib))["proj"]
        for name in ("qk", "qv"):
            np.testing.assert_array_equal(tp[name].numpy(),
                                          np.asarray(jp[name]))
        for name in ("uk", "uv"):
            assert_close(_np(tp[name]), _np(jp[name]))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_filtered_logits_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.standard_normal((6, 64)).astype(np.float32) * 3
    params = [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.5, 10, 0.9),
              (2.0, 1, 1.0), (1.0, 64, 0.5)]
    for row, (t, k, p) in zip(logits, params):
        jv = np.asarray(jax_filtered(jnp.asarray(row), t, k, p))
        tv = _filtered_logits(torch.from_numpy(row), t, k, p).numpy()
        np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
        fin = np.isfinite(jv)
        assert_close(tv[fin], jv[fin])
    # the batched form equals the per-row one
    temps, ks, ps = (torch.tensor(c) for c in zip(*params))
    tb = _filtered_logits(torch.from_numpy(logits), temps, ks, ps).numpy()
    for i, (t, k, p) in enumerate(params):
        np.testing.assert_array_equal(
            tb[i], _filtered_logits(torch.from_numpy(logits[i]), t, k,
                                    p).numpy())


def test_top_k_one_is_greedy_and_draws_are_deterministic():
    logits = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (3, 64)).astype(np.float32))
    B = logits.shape[0]
    ones = torch.ones(B)
    gens = [request_generator(0, i, 0, "cpu") for i in range(B)]
    toks, lps = sample_tokens(logits, ones, torch.ones(B, dtype=torch.long),
                              ones, gens)
    g_toks, g_lps = greedy_tokens(logits)
    np.testing.assert_array_equal(toks.numpy(), g_toks.numpy())
    np.testing.assert_array_equal(lps.numpy(), g_lps.numpy())
    draw = [sample_tokens(logits, ones, torch.zeros(B, dtype=torch.long),
                          ones, [request_generator(7, i, 3, "cpu")
                                 for i in range(B)])[0] for _ in range(2)]
    np.testing.assert_array_equal(draw[0].numpy(), draw[1].numpy())


def test_sampler_matches_filtered_distribution():
    """Chi-square of the torch sampler's draws (one generator per request
    id) against softmax(_filtered_logits), the method of
    tests/test_speculative.py."""
    temp, top_k, top_p = 0.9, 12, 0.95
    logits = np.random.RandomState(6).standard_normal(32).astype(
        np.float32) * 2
    q = np.asarray(jax.nn.softmax(jax_filtered(jnp.asarray(logits), temp,
                                               top_k, top_p)))
    trials, B = 500, 8
    lg = torch.from_numpy(np.tile(logits, (B, 1)))
    temps, ks, ps = (torch.full((B,), temp), torch.full((B,), top_k),
                     torch.full((B,), top_p))
    counts = np.zeros(32, np.int64)
    for t in range(trials):
        gens = [request_generator(1, t * B + i, 0, "cpu") for i in range(B)]
        toks, _ = sample_tokens(lg, temps, ks, ps, gens)
        counts += np.bincount(toks.numpy(), minlength=32)
    n = counts.sum()
    exp = q * n
    big = exp >= 2.0
    obs_b = np.append(counts[big], counts[~big].sum())
    exp_b = np.append(exp[big], exp[~big].sum())
    keep = exp_b > 0
    chi2 = float(((obs_b[keep] - exp_b[keep]) ** 2 / exp_b[keep]).sum())
    dof = int(keep.sum()) - 1
    z = 3.09          # p ~ 1e-3 critical value, Wilson-Hilferty
    crit = dof * (1.0 - 2.0 / (9 * dof) + z * np.sqrt(2.0 / (9 * dof))) ** 3
    assert chi2 < crit, (chi2, crit, dof)
    assert counts[q <= 1e-9].sum() == 0


# ---------------------------------------------------------------------------
# host-side copies and the CLI
# ---------------------------------------------------------------------------

def test_loadgen_and_metrics_match_jax():
    spec_kw = dict(n_requests=12, arrival="poisson", rate_qps=20.0,
                   shared_prefix_fraction=0.5, seed=4)
    assert (loadgen.generate(loadgen.WorkloadSpec(**spec_kw))
            == jax_loadgen.generate(jax_loadgen.WorkloadSpec(**spec_kw)))
    regs = (Registry(enabled=True), JaxRegistry(enabled=True))
    for reg in regs:
        h = reg.histogram("x_s", "x")
        c = reg.counter("n_total", "n", labels=("reason",))
        for v in np.random.RandomState(0).exponential(0.01, 300):
            h.observe(float(v))
        c.labels(reason="timeout").inc(3)
    assert regs[0].snapshot() == regs[1].snapshot()


@pytest.mark.parametrize("flags", [[], ["--cur-kv"]])
def test_serve_cli_runs_on_cpu(flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = tserve.main(["--arch", "llama3.1-8b", "--smoke",
                             "--n-requests", "5", "--new-tokens", "6",
                             "--device", "cpu"] + flags)
    text = out.getvalue()
    assert "completed 5 requests" in text and "slo: ttft p50" in text
    assert stats["completed"] == 5
    assert stats["attn_backends"]["paged_decode"] == "paged_ref"


def _cli_tokens(monkeypatch, flags):
    """Run the serve CLI on a burst workload (every request queued before
    the first step, so the batches do not depend on the host's clock);
    returns ({rid: tokens}, stats, stdout)."""
    made = []

    class Recording(tserve.Server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tserve, "Server", Recording)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = tserve.main(["--arch", "llama3.1-8b", "--smoke",
                             "--n-requests", "4", "--new-tokens", "5",
                             "--arrival", "burst", "--device", "cpu"]
                            + flags)
    toks = {k: r.out_tokens for k, r in made[0].finished.items()}
    return toks, stats, out.getvalue()


def test_serve_cli_legacy_matches_jax(monkeypatch):
    """--legacy runs the static-batch engine; on the same params and
    prompts its greedy tokens equal the JAX CLI's --legacy run (olmo-1b:
    the JAX CLI does not take llama3.1-8b)."""
    from repro.launch import serve as jserve
    jcfg = jax_get_smoke("olmo-1b")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    prompts = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 8))

    class Prompts:
        def __init__(self, *a, **kw):
            pass

        def batch_at(self, step):
            return {"tokens": torch.from_numpy(prompts)}

    class JaxPrompts(Prompts):
        def batch_at(self, step):
            return {"tokens": jnp.asarray(prompts, jnp.int32)}

    got = []
    jgen = jserve.generate

    def jax_generate(*a, **kw):
        got.append(jgen(*a, **kw))
        return got[-1]

    monkeypatch.setattr(jserve, "SyntheticLM", JaxPrompts)
    monkeypatch.setattr(jserve, "init_params", lambda key, cfg: jparams)
    monkeypatch.setattr(jserve, "generate", jax_generate)
    monkeypatch.setattr(tserve, "SyntheticLM", Prompts)
    monkeypatch.setattr(tserve, "init_params",
                        lambda seed, cfg, device: port_params(jparams))
    argv = ["--arch", "olmo-1b", "--smoke", "--legacy", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "5"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jserve.main(argv)
        res = tserve.main(argv + ["--device", "cpu"])
    assert out.getvalue().count("generated 10 tokens in") == 2
    assert res.tokens.shape == (2, 5)
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.asarray(got[0].tokens))


@pytest.mark.parametrize("backend", ["fold", "reconstruct"])
def test_serve_cli_prefill_backend(monkeypatch, backend):
    """--prefill-backend reaches the Server as an argument; the
    full-head-dim reconstruct oracle gives the rank-space fold's tokens
    (the JAX package's long_prompt property)."""
    base, _, _ = _cli_tokens(monkeypatch, ["--cur-kv"])
    toks, stats, _ = _cli_tokens(monkeypatch, ["--cur-kv",
                                               "--prefill-backend", backend])
    want = "reconstruct" if backend == "reconstruct" else "rank_fold"
    assert stats["prefill_backend"] == want
    assert toks == base


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_serve_cli_paged_kernel(monkeypatch, mode):
    """On the CPU both "auto" and "off" take the plain paged attention and
    give the default run's tokens; the serving line names the backend."""
    base, _, _ = _cli_tokens(monkeypatch, [])
    toks, stats, text = _cli_tokens(monkeypatch, ["--paged-kernel", mode])
    assert stats["attn_backends"]["paged_decode"] == "paged_ref"
    assert "paged_decode=paged_ref" in text
    assert toks == base


def test_serve_cli_paged_kernel_on_raises_on_cpu():
    with pytest.raises(ValueError, match="no interpret mode"):
        tserve.main(["--arch", "llama3.1-8b", "--smoke", "--device", "cpu",
                     "--paged-kernel", "on"])


def test_serve_cli_prof_writes_a_trace(monkeypatch, tmp_path):
    toks, _, text = _cli_tokens(monkeypatch, [
        "--prof", "--trace", "--obs-out", str(tmp_path)])
    path = tmp_path / "torchprof" / "serve.0.trace.json"
    assert f"profiler trace -> {path}" in text
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    obs_trace = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert {e["args"]["phase"] for e in obs_trace
            if e["name"] == "prof:serve"} == {"start", "stop"}
    assert len(toks) == 4
