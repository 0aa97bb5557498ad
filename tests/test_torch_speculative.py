"""The port's speculative decoding against the JAX package's, on the same
bridged params and numpy tokens (the suite's tiny config, f32):
``paged_verify`` logits within 2e-5 and pools within 1e-5 of JAX (dense,
CUR-KV at r = hd and hd/2) and bit-identical to S sequential port
``paged_decode`` calls; ``verify_tokens``' greedy accept counts and tokens
equal JAX's; the port ``Server``'s greedy spec-on tokens equal the JAX
``Server``'s spec-on tokens and the port's spec-off tokens; the sampled
path's first token follows the target's filtered distribution
(chi-square, the method and critical value of tests/test_speculative.py);
``early_exit_draft`` shares the target's storage; the serve CLI's
``--draft`` and ``--spec-k``."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_repro as jax_get_repro
from repro.models import init_params as jax_init_params
from repro.serving import PagedConfig as JaxPagedConfig
from repro.serving import Server as JaxServer
from repro.serving import paged_cache as jpc
from repro.serving import runtime as jrt
from repro.serving import speculative as jspd
from repro.serving.sampling import batch_base_keys
from repro_torch.bridge import tree_map
from repro_torch.launch import serve as tserve
from repro_torch.models import init_params
from repro_torch.serving import PagedConfig, SamplingParams, Server
from repro_torch.serving import paged_cache as tpc
from repro_torch.serving import runtime as trt
from repro_torch.serving import speculative as spd
from repro_torch.serving.sampling import _filtered_logits, request_seed

from _torch_helpers import assert_close, port_cfg, port_params

torch.set_num_threads(1)

CALIB = np.random.RandomState(9).randint(0, 512, (2, 32)).astype(np.int32)


@pytest.fixture(scope="module")
def tiny(tiny_cfg, tiny_params):
    return tiny_cfg, tiny_params, port_cfg(tiny_cfg), port_params(tiny_params)


@pytest.fixture(scope="module")
def draft(tiny_cfg):
    """A disagreeing draft: same arch, different init (JAX, port)."""
    jd = jax_init_params(jax.random.PRNGKey(7), tiny_cfg)
    return jd, port_params(jd)


def _kw(cur_kv=False, r=8, **kw):
    kw.setdefault("block_size", 8)
    kw.setdefault("n_blocks", 96)
    kw.setdefault("max_blocks_per_seq", 16)
    return dict(cur_kv=cur_kv, kv_rank=r if cur_kv else 0, **kw)


def _table(pc, lens, headroom=8):
    table = np.full((len(lens), pc.max_blocks_per_seq), -1, np.int32)
    nxt = 0
    for i, n in enumerate(lens):
        nb = pc.blocks_for(n + headroom)
        table[i, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
    assert nxt <= pc.n_blocks
    return table


def _prompts(vocab, lens, seed=3, same=False):
    rng = np.random.RandomState(seed)
    toks = np.zeros((len(lens), int(max(lens)) + 2), np.int32)
    one = rng.randint(0, vocab, max(lens))
    for i, n in enumerate(lens):
        toks[i, :n] = one[:n] if same else rng.randint(0, vocab, n)
    return toks


def _port_prefilled(params, cfg, pc, lens, headroom=8, seed=3, same=False):
    """The port's cache after prefilling ragged prompts: (cache, table,
    ctx, next_tok) with host table / ctx."""
    table = _table(pc, lens, headroom)
    toks = _prompts(cfg.vocab_size, lens, seed, same)
    cache = tpc.init_paged_cache(cfg, pc, "cpu")
    if pc.cur_kv:
        cache = trt.calibrate_kv(params, cfg, pc, cache,
                                 torch.from_numpy(CALIB % cfg.vocab_size))
    ctx = torch.tensor(lens, dtype=torch.int32)
    logits, cache = trt.paged_prefill(params, cfg, pc, torch.from_numpy(toks),
                                      ctx, cache, torch.from_numpy(table))
    return cache, torch.from_numpy(table), ctx, logits.argmax(-1)


def _clone(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def _greedy_ref(params, cfg, pc, cache, table, ctx, next_tok, steps):
    """Sequential greedy port paged_decode stream (the exactness oracle)."""
    active = torch.ones(len(ctx), dtype=torch.bool)
    c, t, cx, out = _clone(cache), next_tok[:, None], ctx.clone(), []
    for _ in range(steps):
        lg, c = trt.paged_decode(params, cfg, pc, t, c, table, cx, active)
        t = lg.argmax(-1)[:, None]
        out.append(t[:, 0].numpy())
        cx = cx + 1
    return np.stack(out, 1)


# ---------------------------------------------------------------------------
# paged_verify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cur_kv,r", [(False, 0), (True, 16), (True, 8)])
def test_paged_verify_matches_jax(tiny, cur_kv, r):
    """Logits within 2e-5 and pools within 1e-5 of the JAX paged_verify,
    after the same prefill, with one inactive slot."""
    jcfg, jparams, cfg, params = tiny
    kw = _kw(cur_kv, r)
    jpcfg, pc = JaxPagedConfig(**kw), PagedConfig(**kw)
    lens = [11, 7, 14, 9]
    table = _table(pc, lens)
    toks = _prompts(cfg.vocab_size, lens)
    jc = jpc.init_paged_cache(jcfg, jpcfg)
    tc = tpc.init_paged_cache(cfg, pc, "cpu")
    if cur_kv:
        jc = jrt.calibrate_kv(jparams, jcfg, jpcfg, jc, jnp.asarray(CALIB))
        tc = trt.calibrate_kv(params, cfg, pc, tc, torch.from_numpy(CALIB))
    lens_np = np.asarray(lens, np.int32)
    jl, jc = jrt.paged_prefill(jparams, jcfg, jpcfg, jnp.asarray(toks),
                               jnp.asarray(lens_np), jc, jnp.asarray(table))
    _, tc = trt.paged_prefill(params, cfg, pc, torch.from_numpy(toks),
                              torch.from_numpy(lens_np), tc,
                              torch.from_numpy(table))
    S = 5
    rng = np.random.RandomState(5)
    win = np.concatenate([np.asarray(jnp.argmax(jl, -1))[:, None],
                          rng.randint(0, cfg.vocab_size, (len(lens), S - 1))],
                         axis=1).astype(np.int32)
    active = np.array([True, True, False, True])
    jv, jc = jrt.paged_verify(jparams, jcfg, jpcfg, jnp.asarray(win), jc,
                              jnp.asarray(table), jnp.asarray(lens_np),
                              jnp.asarray(active))
    tv, tc = trt.paged_verify(params, cfg, pc, torch.from_numpy(win), tc,
                              torch.from_numpy(table),
                              torch.from_numpy(lens_np),
                              torch.from_numpy(active))
    assert tv.shape == (len(lens), S, cfg.vocab_size)
    assert_close(tv[active].numpy(), np.asarray(jv)[active])
    for name in ("k", "v"):
        assert_close(tc[name].numpy(), np.asarray(jc[name]), tol=1e-5)


@pytest.mark.parametrize("cur_kv", [False, True])
def test_paged_verify_bit_identical_to_sequential(tiny, cur_kv):
    """One verify forward over S positions gives the bits of S sequential
    port paged_decode calls: logits and pools."""
    _, _, cfg, params = tiny
    pc = PagedConfig(**_kw(cur_kv))
    cache, table, ctx, nt = _port_prefilled(params, cfg, pc, [11, 7, 14])
    B, S = len(ctx), 4
    active = torch.ones(B, dtype=torch.bool)
    rng = np.random.RandomState(5)
    win = torch.cat([nt[:, None], torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (B, S - 1)))], dim=1)
    ref_cache, refs = _clone(cache), []
    for j in range(S):
        lg, ref_cache = trt.paged_decode(params, cfg, pc, win[:, j:j + 1],
                                         ref_cache, table, ctx + j, active)
        refs.append(lg)
    logits, vcache = trt.paged_verify(params, cfg, pc, win, _clone(cache),
                                      table, ctx, active)
    for j in range(S):
        assert torch.equal(logits[:, j], refs[j])
    for name in ("k", "v"):
        assert torch.equal(vcache[name], ref_cache[name])


# ---------------------------------------------------------------------------
# draft / verify acceptance
# ---------------------------------------------------------------------------

_ZEROS = (np.zeros(3, np.int64), np.arange(3), torch.zeros(3),
          torch.zeros(3, dtype=torch.long), torch.ones(3))


def _jax_verify(jcfg, jparams, win, bad):
    """The JAX verify_tokens (greedy) after the JAX prefill of the same
    prompts: (emitted, n_emit) as numpy."""
    jpcfg = JaxPagedConfig(**_kw())
    lens = [11, 7, 14]
    table = _table(jpcfg, lens)
    toks = _prompts(jcfg.vocab_size, lens)
    jc = jpc.init_paged_cache(jcfg, jpcfg)
    _, jc = jrt.paged_prefill(jparams, jcfg, jpcfg, jnp.asarray(toks),
                              jnp.asarray(np.asarray(lens, np.int32)), jc,
                              jnp.asarray(table))
    B = len(lens)
    keys = batch_base_keys(jnp.arange(B, dtype=jnp.int32),
                           jnp.arange(B, dtype=jnp.int32))
    zeros = (jnp.zeros((B,), jnp.float32), jnp.zeros((B,), jnp.int32),
             jnp.ones((B,), jnp.float32))
    emitted, n_emit, _, _ = jspd.verify_tokens(
        jparams, jcfg, jpcfg, jnp.asarray(win), jnp.asarray(bad), None, jc,
        jnp.asarray(table), jnp.asarray(np.asarray(lens, np.int32)),
        jnp.ones((B,), bool), keys, jnp.ones((B,), jnp.int32), *zeros,
        greedy=True)
    return np.asarray(emitted), np.asarray(n_emit)


def test_self_draft_greedy_accepts_everything(tiny):
    """A draft equal to the target proposes the sequential greedy stream
    and verify accepts all k, emitting the bonus token; JAX's verify of the
    same proposals emits the same tokens."""
    jcfg, jparams, cfg, params = tiny
    pc = PagedConfig(**_kw())
    k = 4
    cache, table, ctx, nt = _port_prefilled(params, cfg, pc, [11, 7, 14])
    active = torch.ones(3, dtype=torch.bool)
    ref = _greedy_ref(params, cfg, pc, cache, table, ctx, nt, k + 1)
    gs = np.ones(3, np.int64)
    d_toks, d_probs, _ = spd.draft_tokens(
        params, cfg, pc, nt[:, None], _clone(cache), table, ctx, active,
        _ZEROS, gs, k, greedy=True)
    assert d_probs is None
    np.testing.assert_array_equal(d_toks.numpy(), ref[:, :k])
    win = torch.cat([nt[:, None], d_toks], dim=1)
    emitted, n_emit, lps, _ = spd.verify_tokens(
        params, cfg, pc, win, d_toks, None, _clone(cache), table, ctx,
        active, _ZEROS, gs, greedy=True)
    assert (n_emit.numpy() == k + 1).all()
    np.testing.assert_array_equal(emitted.numpy(), ref)
    assert torch.isfinite(lps).all()
    j_emitted, j_n = _jax_verify(jcfg, jparams, win.numpy().astype(np.int32),
                                 d_toks.numpy().astype(np.int32))
    np.testing.assert_array_equal(j_n, n_emit.numpy())
    np.testing.assert_array_equal(j_emitted, emitted.numpy())


def test_wrong_draft_greedy_truncates_with_correction(tiny):
    jcfg, jparams, cfg, params = tiny
    pc = PagedConfig(**_kw())
    k = 4
    cache, table, ctx, nt = _port_prefilled(params, cfg, pc, [11, 7, 14])
    active = torch.ones(3, dtype=torch.bool)
    ref = _greedy_ref(params, cfg, pc, cache, table, ctx, nt, k + 1)
    bad = ref[:, :k].copy()
    bad[0, 2] = (bad[0, 2] + 1) % cfg.vocab_size   # reject at j=2
    bad[2, 0] = (bad[2, 0] + 9) % cfg.vocab_size   # reject at j=0
    win = np.concatenate([nt.numpy()[:, None], bad], axis=1)
    emitted, n_emit, _, _ = spd.verify_tokens(
        params, cfg, pc, torch.from_numpy(win), torch.from_numpy(bad), None,
        _clone(cache), table, ctx, active, _ZEROS, np.ones(3, np.int64),
        greedy=True)
    emitted, n_emit = emitted.numpy(), n_emit.numpy()
    assert list(n_emit) == [3, k + 1, 1]
    for i in range(3):
        a = n_emit[i] - 1
        np.testing.assert_array_equal(emitted[i, :a], bad[i, :a])
        assert emitted[i, a] == ref[i, a]
    j_emitted, j_n = _jax_verify(jcfg, jparams, win.astype(np.int32),
                                 bad.astype(np.int32))
    np.testing.assert_array_equal(j_n, n_emit)
    for i in range(3):
        np.testing.assert_array_equal(j_emitted[i, :n_emit[i]],
                                      emitted[i, :n_emit[i]])


# ---------------------------------------------------------------------------
# served output: speculation on == off (greedy, eos, fallback)
# ---------------------------------------------------------------------------

def _serve(cls, cfg, params, pc, wl, *, spec_k=0, draft=None, draft_cfg=None,
           draft_pc=None, temp=0.0, eos=None, C=3):
    kw = dict(device="cpu") if cls is Server else {}
    sp = SamplingParams
    if cls is JaxServer:
        from repro.serving import SamplingParams as sp
    srv = cls(params, cfg, pc=pc, max_concurrency=C, draft_params=draft,
              draft_cfg=draft_cfg, draft_pc=draft_pc, spec_k=spec_k,
              calib_tokens=CALIB if cls is Server else jnp.asarray(CALIB),
              **kw)
    for i, (p, mn) in enumerate(wl):
        srv.submit(p, mn, sampling=sp(temperature=temp, seed=i), eos_id=eos)
    done = srv.drain()
    return srv, {r.rid: list(r.out_tokens) for r in done.values()}


@pytest.fixture(scope="module")
def workload(tiny_cfg):
    rng = np.random.RandomState(0)
    return [(list(rng.randint(0, tiny_cfg.vocab_size, rng.randint(6, 30))),
             int(rng.randint(5, 24))) for _ in range(6)]


@pytest.mark.parametrize("cur_kv", [False, True])
def test_server_spec_greedy_matches_jax_and_spec_off(tiny, draft, workload,
                                                     cur_kv):
    """Port spec-on == JAX spec-on == port spec-off, token for token, with
    a self-draft (accepts everything) and a disagreeing draft (changes only
    the accept rate)."""
    jcfg, jparams, cfg, params = tiny
    kw = _kw(cur_kv)
    pc = PagedConfig(**kw)
    _, base = _serve(Server, cfg, params, pc, workload)
    srv, out = _serve(Server, cfg, params, pc, workload, spec_k=4,
                      draft=params)
    assert out == base
    st = srv.stats()
    assert st["n_spec_windows"] > 0 and st["spec_accept_rate"] == 1.0
    assert srv.scheduler.alloc.n_free == pc.n_blocks
    jsrv, jout = _serve(JaxServer, jcfg, jparams, JaxPagedConfig(**kw),
                        workload, spec_k=4, draft=jparams)
    assert jout == out
    assert jsrv.stats()["n_spec_windows"] == st["n_spec_windows"]
    srv2, out2 = _serve(Server, cfg, params, pc, workload, spec_k=4,
                        draft=draft[1])
    assert out2 == base
    assert srv2.stats()["spec_accept_rate"] < 1.0


def test_server_spec_early_exit_draft(tiny, workload):
    _, _, cfg, params = tiny
    pc = PagedConfig(**_kw())
    _, base = _serve(Server, cfg, params, pc, workload)
    d, dcfg = spd.early_exit_draft(params, cfg, 2)
    srv, out = _serve(Server, cfg, params, pc, workload, spec_k=3, draft=d,
                      draft_cfg=dcfg)
    assert out == base
    assert srv.draft_cfg.n_layers == 2 and srv.stats()["n_spec_windows"] > 0


def test_server_spec_draft_own_pool(tiny, workload):
    """The draft runs its own CUR-KV pool over the shared block table."""
    _, _, cfg, params = tiny
    pc = PagedConfig(**_kw())
    _, base = _serve(Server, cfg, params, pc, workload)
    srv, out = _serve(Server, cfg, params, pc, workload, spec_k=3,
                      draft=params, draft_pc=PagedConfig(**_kw(True)))
    assert out == base
    assert srv.draft_pc.cur_kv and not srv.pc.cur_kv
    assert srv.draft_pc.n_blocks == pc.n_blocks
    assert srv.draft_cache["k"].shape[-1] == 8


def test_server_spec_eos_truncation(tiny, workload):
    _, _, cfg, params = tiny
    pc = PagedConfig(**_kw())
    srv0, base = _serve(Server, cfg, params, pc, workload, eos=11)
    srv, out = _serve(Server, cfg, params, pc, workload, spec_k=4,
                      draft=params, eos=11)
    assert out == base
    assert ({i: r.finish_reason for i, r in srv.finished.items()}
            == {i: r.finish_reason for i, r in srv0.finished.items()})
    assert "eos" in {r.finish_reason for r in srv.finished.values()}


def test_server_spec_fallback_and_block_accounting(tiny, workload):
    """A pool too small to fork falls back to plain decode (never preempts
    from the spec path); the output is unchanged, the draft-KV sync keeps
    self-draft acceptance at 1, and every block returns."""
    _, _, cfg, params = tiny
    pc = PagedConfig(**_kw(block_size=4, n_blocks=18))
    _, base = _serve(Server, cfg, params, pc, workload, C=4)
    srv, out = _serve(Server, cfg, params, pc, workload, spec_k=6,
                      draft=params, C=4)
    assert out == base
    st = srv.stats()
    assert st["n_spec_fallbacks"] > 0
    assert st["spec_accept_rate"] == 1.0
    assert srv.scheduler.alloc.n_free == pc.n_blocks
    srv.scheduler.alloc.assert_used(exactly=0)


def test_server_spec_temperature_runs(tiny, draft, workload):
    _, _, cfg, params = tiny
    pc = PagedConfig(**_kw())
    srv, out = _serve(Server, cfg, params, pc, workload, spec_k=4,
                      draft=draft[1], temp=0.8)
    assert len(out) == len(workload)
    for r in srv.finished.values():
        assert r.finish_reason == "length"
        assert len(r.out_tokens) == len(r.out_logprobs)
        assert all(np.isfinite(lp) for lp in r.out_logprobs)
    assert srv.stats()["n_spec_windows"] > 0
    assert srv.scheduler.alloc.n_free == pc.n_blocks
    # the same seeds draw the same tokens again
    _, again = _serve(Server, cfg, params, pc, workload, spec_k=4,
                      draft=draft[1], temp=0.8)
    assert again == out


# ---------------------------------------------------------------------------
# draws: distribution exactness at temperature > 0
# ---------------------------------------------------------------------------

def test_speculative_streams_are_seeded_and_disjoint():
    s = {spd.draw_seed(1, 2, tag, 3, 0)
         for tag in (spd.TAG_DRAFT, spd.TAG_ACCEPT, spd.TAG_RESAMPLE)}
    assert len(s) == 3 and request_seed(1, 2, 3) not in s
    u = spd.window_uniforms(np.array([1, 1]), np.array([0, 1]),
                            np.array([4, 4]), np.array([True, False]),
                            spd.TAG_ACCEPT, 3)
    assert u.shape == (2, 3) and (u[1] == 0.5).all()
    assert ((u[0] >= 0) & (u[0] < 1)).all() and len(set(u[0].tolist())) == 3
    assert torch.equal(u, spd.window_uniforms(
        np.array([1, 1]), np.array([0, 1]), np.array([4, 4]),
        np.array([True, False]), spd.TAG_ACCEPT, 3))


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.9, 0, 1.0),       # pure temperature
    (1.2, 8, 0.85),      # nucleus + top-k filtering
])
def test_spec_sampling_matches_target_distribution(temp, top_k, top_p):
    """Chi-square closeness of the port's own draws: the first emitted
    token of draft-then-verify (draft ~ p, accept u p <= q, resample the
    residual) follows the target's filtered single-step distribution q.
    Vocab, batch, trials and critical value as tests/test_speculative.py."""
    cfg0 = jax_get_repro()
    jcfg = cfg0.replace(
        name="tiny-v31", d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=31,
        groups=((cfg0.groups[0][0], 2),), scan_layers=False)
    cfg = port_cfg(jcfg)
    params = init_params(0, cfg, "cpu")
    dparams = init_params(5, cfg, "cpu")
    pc = PagedConfig(block_size=8, n_blocks=256, max_blocks_per_seq=4)
    B, k, trials = 64, 3, 10
    lens = [9] * B
    cache, table, ctx, nt = _port_prefilled(params, cfg, pc, lens,
                                            headroom=6, same=True)
    dcache, _, _, _ = _port_prefilled(dparams, cfg, pc, lens, headroom=6,
                                      same=True)
    active = torch.ones(B, dtype=torch.bool)
    gs = np.ones(B, np.int64)
    sampling = lambda rids: (np.ones(B, np.int64), rids,       # noqa: E731
                             torch.full((B,), temp),
                             torch.full((B,), top_k, dtype=torch.long),
                             torch.full((B,), top_p))
    lg0, _ = trt.paged_decode(params, cfg, pc, nt[:, None], _clone(cache),
                              table, ctx, active)
    q = torch.softmax(_filtered_logits(lg0[0].float(), temp, top_k, top_p),
                      -1).numpy()
    counts = np.zeros((cfg.vocab_size,), np.int64)
    for t in range(trials):
        smp = sampling(np.arange(t * B, (t + 1) * B))
        d_toks, d_probs, _ = spd.draft_tokens(
            dparams, cfg, pc, nt[:, None], _clone(dcache), table, ctx,
            active, smp, gs, k)
        emitted, _, _, _ = spd.verify_tokens(
            params, cfg, pc, torch.cat([nt[:, None], d_toks], 1), d_toks,
            d_probs, _clone(cache), table, ctx, active, smp, gs)
        counts += np.bincount(emitted[:, 0].numpy(),
                              minlength=cfg.vocab_size)
    n = counts.sum()
    assert n == B * trials
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
# early-exit drafts
# ---------------------------------------------------------------------------

def test_early_exit_draft_shares_storage_and_matches_jax(tiny):
    jcfg, jparams, cfg, params = tiny
    d, dcfg = spd.early_exit_draft(params, cfg, 2)
    jd, jdcfg = jspd.early_exit_draft(jparams, jcfg, 2)
    assert dcfg.n_layers == jdcfg.n_layers == 2
    assert dcfg.groups == port_cfg(jdcfg).groups
    mine, ref, whole = ([], [], [])
    tree_map(mine.append, d["groups"])
    tree_map(ref.append, port_params(jd)["groups"])
    tree_map(whole.append, params["groups"])
    assert len(mine) == len(ref) == len(whole) > 0
    for leaf, jleaf, tleaf in zip(mine, ref, whole):
        assert torch.equal(leaf, jleaf)
        assert leaf.shape[0] == 2 and tleaf.shape[0] == 4
        assert leaf.data_ptr() == tleaf.data_ptr()      # a view, no copy
    assert d["embed"] is params["embed"]


def test_early_exit_draft_raises_on_multi_group(tiny):
    _, _, cfg, params = tiny
    spec = cfg.groups[0][0]
    multi = cfg.replace(groups=((spec, 1), (spec, 3)))
    with pytest.raises(ValueError, match="single-group"):
        spd.early_exit_draft(params, multi, 1)
    with pytest.raises(ValueError, match=">= 1 layer"):
        spd.early_exit_draft(params, cfg, 0)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--draft", "self:2", "--spec-k", "3"],
                                   ["--draft", "self", "--spec-k", "2",
                                    "--cur-kv", "--draft-kv-rank", "4"]])
def test_serve_cli_speculative(flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = tserve.main(["--arch", "llama3.1-8b", "--smoke",
                             "--n-requests", "5", "--new-tokens", "6",
                             "--device", "cpu"] + flags)
    text = out.getvalue()
    assert "speculative: accept rate" in text
    assert stats["completed"] == 5 and stats["n_spec_windows"] > 0
    assert stats["spec_k"] == int(flags[3])


def test_serve_cli_draft_dir_restores_checkpoint(tmp_path):
    """--draft DIR restores DIR/template.json and the newest valid step
    through the port's checkpoint manager; a checkpoint of the target's
    own params drafts as ``self`` does: accept rate 1."""
    from repro_torch.configs import get_smoke
    from repro_torch.dist import CheckpointManager, save_tree_template
    from repro_torch.models import init_params
    tree = {"params": init_params(0, get_smoke("llama3.1-8b"), "cpu")}
    CheckpointManager(str(tmp_path), keep_n=1).save(3, tree)
    save_tree_template(str(tmp_path / "template.json"), tree)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = tserve.main(["--arch", "llama3.1-8b", "--smoke",
                             "--n-requests", "4", "--new-tokens", "6",
                             "--device", "cpu", "--draft", str(tmp_path),
                             "--spec-k", "3"])
    assert f"draft checkpoint {tmp_path} (step 3)" in out.getvalue()
    assert stats["completed"] == 4 and stats["n_spec_windows"] > 0
    assert stats["spec_accept_rate"] == 1.0


def test_serve_load_draft_unrolls_a_cured_tree(tiny, tmp_path):
    """A CURed checkpoint (cure's save stage: per-layer groups) restores
    with the target's config unrolled, so every layer reads its own
    params."""
    from repro_torch.configs.base import CURConfig
    from repro_torch.core import calibrate, compress_model
    from repro_torch.dist import CheckpointManager, save_tree_template
    from repro_torch.models import forward
    _, _, cfg, params = tiny
    toks = torch.from_numpy(CALIB[:, :16]).long()
    cp, ccfg, _ = compress_model(params, cfg, CURConfig(
        r_max=8, n_compress_layers=1, svd="exact"),
        calibrate(params, cfg, [{"tokens": toks}]))
    CheckpointManager(str(tmp_path)).save(0, {"params": cp})
    save_tree_template(str(tmp_path / "template.json"), {"params": cp})
    step, dp, dcfg = tserve.load_draft(str(tmp_path), cfg, "cpu")
    assert step == 0 and dcfg == ccfg != cfg
    assert torch.equal(forward(dp, dcfg, {"tokens": toks}),
                       forward(cp, ccfg, {"tokens": toks}))
    same_step, _, same_cfg = tserve.load_draft(str(tmp_path), ccfg, "cpu")
    assert same_step == 0 and same_cfg == ccfg
