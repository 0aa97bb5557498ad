"""K-EXAONE-236B-A23B on the port (CPU, float32, SMOKE sizes) against the
plain reference ``perfbench/reference/kexaone.py``: forward logits, the
calibration statistics (per held expert over its routed tokens, the
shared expert over all), the held shares adding up to the uncut layer,
``compress_model``'s WANDA x DEIM indices, the folded model's forward,
prefill then decode through the dense cache and the paged pool, and
``launch/cure.py`` end to end; the MoE repairs (CUR expert stacks through
``_expert_mm``, counts of a held share) and what other MoE configs CUR."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.cure_moe import _weight, make_params, ref_layer  # noqa: E402
from reference import cur as rcur  # noqa: E402
from reference import kexaone as rk  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCHS, PORT_ARCHS, get_config, get_smoke)
from repro_torch.configs.base import (  # noqa: E402
    ATTN_LOCAL, MOE, CURConfig)
from repro_torch.core import calibrate, compress_model  # noqa: E402
from repro_torch.core.compress import _cur_work_list  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.mlp import mlp_forward  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    decode_step, init_cache, iter_layer_params, prefill)

torch.set_num_threads(1)

ARCH = "k-exaone-236b-a23b"
SMOKE = get_smoke(ARCH)
B, S, PRE = 2, 24, 14


def ref_spec(cfg):
    """The reference's configuration (the source's key names) of a port
    config."""
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "sliding_window": cfg.window, "num_hidden_layers": cfg.n_layers,
        "layer_types": ["sliding_attention" if b.mixer == ATTN_LOCAL
                        else "full_attention" for b in cfg.blocks],
        "mlp_layer_types": ["sparse" if b.mlp == MOE else "dense"
                            for b in cfg.blocks],
        "num_experts_per_tok": cfg.n_experts_per_tok, "norm_topk_prob": True,
        "routed_scaling_factor": cfg.routed_scaling,
        "expert_first": cfg.expert_first,
        "num_experts": cfg.n_local_experts}


def _scales(tree, gen):
    """Norm scales drawn around 1, so that a norm left out shows."""
    if isinstance(tree, dict):
        return {k: (1.0 + 0.2 * torch.randn(v.shape, generator=gen)
                    if k in ("scale", "q_norm", "k_norm")
                    else _scales(v, gen)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scales(v, gen) for v in tree]
    return tree


def _share(params, first, n):
    """The params of the held share of experts [first, first + n)."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: (v[:, first:first + n] if k in tmoe._EXPERTS
                        and "router" in tree else cut(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [cut(v) for v in tree]
        return tree
    return cut(params)


@pytest.fixture(scope="module")
def model():
    """(cfg, params): the SMOKE with decaying-spectrum CUR targets (as the
    benchmark draws them) and norm scales around 1."""
    params = make_params(SMOKE, 4.0, 5, torch.device("cpu"))
    return SMOKE, _scales(params, torch.Generator().manual_seed(6))


def _variant(model, share):
    cfg, params = model
    if share:
        cfg = cfg.replace(expert_first=4, experts_held=4)
        params = _share(params, 4, 4)
    return cfg, params


def _tokens(seed=0, shape=(B, S)):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, SMOKE.vocab_size, shape, generator=g)


def _ref_logits(params, cfg, tokens):
    with rk.no_tf32():
        return rk.forward(tokens, lambda li: ref_layer(params, cfg, li),
                          params["embed"], params["out_head"],
                          params["final_norm"]["scale"], ref_spec(cfg))


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def test_registered_beside_archs():
    assert PORT_ARCHS == (ARCH,) and ARCH not in ARCHS and len(ARCHS) == 11
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_experts,
            full.n_experts_per_tok, full.moe_d_ff, full.d_ff) == (
        48, 6144, 128, 8, 2048, 18432)
    assert [b.mixer == ATTN_LOCAL for b in full.blocks][:8] == [
        True, True, True, False] * 2
    assert [b.mlp == MOE for b in full.blocks] == [False] + [True] * 47
    # 236B parameters, 23B active (no MTP layer)
    assert round(full.param_count() / 1e9) == 237
    assert round(full.active_param_count() / 1e9) == 24


@pytest.mark.parametrize("share", [False, True], ids=["all", "share"])
def test_forward_matches_reference(model, share):
    cfg, params = _variant(model, share)
    tokens = _tokens()
    with torch.no_grad():
        got = forward(params, cfg, {"tokens": tokens})
    assert _rel(got, _ref_logits(params, cfg, tokens)) < 2e-5


@pytest.mark.parametrize("share", [False, True], ids=["all", "share"])
def test_calibration_statistics_match_reference(model, share):
    cfg, params = _variant(model, share)
    tokens = _tokens(1)
    calib = calibrate(params, cfg, [{"tokens": tokens}])
    with rk.no_tf32():
        act, routed, _ = rk.calibrate(
            tokens, lambda li: ref_layer(params, cfg, li), params["embed"],
            ref_spec(cfg), cfg.cur_targets)
    for li in range(cfg.n_layers):
        assert act[li], li
        for t, want in act[li].items():
            got = torch.from_numpy(np.asarray(calib.act_sq[li][t]))
            assert got.shape == want.shape, (li, t)
            assert _rel(got, want) < 1e-5, (li, t)
        if li in routed:
            np.testing.assert_array_equal(calib.expert_tokens[li],
                                          routed[li].numpy())
            assert calib.expert_tokens[li].sum() > 0
        else:
            assert calib.expert_tokens[li] is None
    moe = [li for li in routed]
    assert moe == list(range(1, cfg.n_layers))


def test_held_shares_add_up_to_the_uncut_layer(model):
    """The four shares' routed parts, the shared expert counted once, sum
    to the uncut layer, which is the reference's layer."""
    cfg, params = model
    p = next(lp for li, _, lp in iter_layer_params(params, cfg) if li == 1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((B, 12, cfg.d_model), generator=g)
    with torch.no_grad():
        whole = tmoe.moe_dense(x, p, cfg)
        shared = mlp_forward(x, p["shared"], cfg)
        parts = sum(
            tmoe.moe_dense(x, {k: v[s:s + 2] if k in tmoe._EXPERTS else v
                               for k, v in p.items()},
                           cfg.replace(expert_first=s, experts_held=2))
            - shared for s in range(0, 8, 2))
    assert _rel(parts + shared, whole) < 1e-5
    with rk.no_tf32():
        want = rk.moe(x.reshape(-1, cfg.d_model), ref_layer(params, cfg, 1),
                      ref_spec(cfg))
    assert _rel(whole.reshape(-1, cfg.d_model), want) < 1e-5


def _cured(model, share, pipeline="batched"):
    cfg, params = _variant(model, share)
    tokens = _tokens(3, (2, 32))
    calib = calibrate(params, cfg, [{"tokens": tokens}])
    ccfg = CURConfig(r_max=8, selection="wanda_deim", svd="exact",
                     fold_u=True, pipeline=pipeline, seed=9)
    new, ncfg, info = compress_model(params, cfg, ccfg, calib,
                                     layers=[3, 5])
    return cfg, params, tokens, new, ncfg, info


@pytest.mark.parametrize("share", [False, True], ids=["all", "share"])
def test_compress_indices_equal_reference(model, share):
    cfg, params, tokens, _, _, info = _cured(model, share)
    E = cfg.n_local_experts
    names = [(w.layer, w.name, w.expert) for w in info.weights]
    assert names == [(li, t, e) for li in (3, 5) for t, es in (
        ("wq", [None]), ("wk", [None]), ("shared.w_gate", [None]),
        ("experts.w_gate", range(E))) for e in es]
    with rk.no_tf32():
        act, _, _ = rk.calibrate(
            tokens, lambda li: ref_layer(params, cfg, li), params["embed"],
            ref_spec(cfg), cfg.cur_targets)
    for w in info.weights:
        W = _weight(ref_layer(params, cfg, w.layer), w.name, w.expert)
        a = act[w.layer][w.name]
        want = rcur.cur_weight(W, a if w.expert is None else a[w.expert],
                               w.rank)
        assert list(w.rows) == want["p"], (w.layer, w.name, w.expert)
        assert list(w.cols) == want["q"], (w.layer, w.name, w.expert)


def test_loop_pipeline_makes_the_batched_selections(model):
    a = _cured(model, True)[-1].weights
    b = _cured(model, True, "loop")[-1].weights
    assert [(w.name, w.expert) for w in a] == [(w.name, w.expert) for w in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.rows, y.rows)
        np.testing.assert_array_equal(x.cols, y.cols)


def _dense_equivalent(tree):
    """A compressed tree with every CUR dict multiplied out."""
    if isinstance(tree, dict):
        if "CU" in tree:
            return tree["CU"] @ tree["R"]
        return {k: _dense_equivalent(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dense_equivalent(v) for v in tree]
    return tree


@pytest.mark.parametrize("share", [False, True], ids=["all", "share"])
def test_folded_model_matches_reference(model, share):
    _, _, tokens, new, ncfg, _ = _cured(model, share)
    blk = new["groups"][3][0]
    assert set(blk["w_gate"]) == {"CU", "R"}
    assert blk["w_gate"]["CU"].shape == (1, ncfg.n_local_experts,
                                         ncfg.d_model, 8)
    assert set(blk["shared"]["w_gate"]) == {"CU", "R"}
    with torch.no_grad():
        got = forward(new, ncfg, {"tokens": tokens})
    dense = _dense_equivalent(new)
    assert _rel(got, _ref_logits(dense, ncfg, tokens)) < 2e-5


@pytest.mark.parametrize("cured", [False, True], ids=["dense", "cured"])
def test_prefill_then_decode_matches_forward(model, cured):
    """The dense cache (window layers' ring buffers of 8 slots) and the
    paged pool: prefill PRE tokens, decode the rest one at a time."""
    from repro_torch.serving.paged_cache import PagedConfig, init_paged_cache
    from repro_torch.serving.runtime import paged_decode, paged_prefill
    if cured:
        _, _, _, params, cfg, _ = _cured(model, True)
    else:
        cfg, params = _variant(model, True)
    tokens = _tokens(4)
    with torch.no_grad():
        want = forward(params, cfg, {"tokens": tokens})
        cache = init_cache(cfg, B, S, "cpu")
        logits, cache = prefill(params, cfg, {"tokens": tokens[:, :PRE]},
                                cache)
        dense = [logits]
        for j in range(PRE, S - 1):
            logits, cache = decode_step(
                params, cfg, {"tokens": tokens[:, j:j + 1]}, cache,
                torch.full((B, 1), j, dtype=torch.int32))
            dense.append(logits)
        pc = PagedConfig(block_size=8, n_blocks=2 * 4, max_blocks_per_seq=4)
        pool = init_paged_cache(cfg, pc, "cpu")
        table = torch.arange(2 * 4).reshape(2, 4)
        logits, pool = paged_prefill(params, cfg, pc, tokens[:, :PRE],
                                     torch.full((B,), PRE), pool, table)
        paged = [logits]
        for j in range(PRE, S - 1):
            logits, pool = paged_decode(
                params, cfg, pc, tokens[:, j:j + 1], pool, table,
                torch.full((B,), j), torch.ones(B, dtype=torch.bool))
            paged.append(logits)
    ref = want[:, PRE - 1:S - 1].transpose(0, 1)
    assert _rel(torch.stack(dense), ref) < 2e-5
    assert _rel(torch.stack(paged), ref) < 2e-5


def test_cure_cli_end_to_end(tmp_path):
    from repro_torch.launch import cure
    args = cure.parser().parse_args([
        "--arch", ARCH, "--smoke", "--layers", "2", "--r-max", "8",
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    report = cure.cure(args)
    names = {w["name"] for w in report["weights"]}
    assert names == {"wq", "wk", "shared.w_gate", "experts.w_gate"}
    assert report["n_weights"] == 2 * (3 + SMOKE.n_experts)
    assert report["params"]["saved_deployed"] > 0
    assert report["generate"]["tokens"] > 0


def test_a_held_expert_without_tokens_raises(model):
    cfg, params = _variant(model, True)
    calib = calibrate(params, cfg, [{"tokens": _tokens(5, (1, 8))}])
    calib.expert_tokens[3][1] = 0
    with pytest.raises(ValueError, match="saw no calibration token"):
        compress_model(params, cfg, CURConfig(r_max=8), calib, layers=[3])


def test_a_held_share_under_a_mesh_is_refused(model):
    cfg, params = _variant(model, True)
    p = next(lp for li, _, lp in iter_layer_params(params, cfg) if li == 1)
    with pytest.raises(NotImplementedError, match="held share"):
        tmoe.moe_forward(torch.zeros((1, 2, cfg.d_model)), p, cfg,
                         mesh=object())


# ---------------------------------------------------------------------------
# the MoE repairs, and what the other MoE configs CUR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_dense_moe_runs_cur_expert_stacks(scoring):
    """``_routed_dense`` on a CUR stack (F from R) and ``_experts``
    through ``_expert_mm``: the layer equals the one with CU @ R dense."""
    cfg = get_smoke("mixtral-8x22b").replace(moe_scoring=scoring)
    g = torch.Generator().manual_seed(3)
    E, D, F, r = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, 6
    cu = torch.randn((E, D, r), generator=g) / D ** 0.5
    R = torch.randn((E, r, F), generator=g) / r ** 0.5
    p = {"router": torch.randn((D, E), generator=g) / D ** 0.5,
         "w_up": torch.randn((E, D, F), generator=g) / D ** 0.5,
         "w_down": torch.randn((E, F, D), generator=g) / F ** 0.5}
    x = torch.randn((2, 5, D), generator=g)
    got = tmoe.moe_dense(x, dict(p, w_gate={"CU": cu, "R": R}), cfg)
    want = tmoe.moe_dense(x, dict(p, w_gate=cu @ R), cfg)
    assert _rel(got, want) < 1e-5
    held = cfg.replace(expert_first=2, experts_held=2)
    sl = {k: v[2:4] for k, v in p.items() if k != "router"}
    got = tmoe.moe_dense(x, dict(sl, router=p["router"], w_gate={
        "CU": cu[2:4], "R": R[2:4]}), held)
    want = tmoe.moe_dense(x, dict(sl, router=p["router"],
                                  w_gate=(cu @ R)[2:4]), held)
    assert _rel(got, want) < 1e-5


def test_param_counts_of_a_held_share():
    full = get_config(ARCH)
    share = full.replace(experts_held=32)
    d, ff = full.d_model, full.moe_d_ff
    n_moe = sum(b.mlp == MOE for b in full.blocks)
    assert full.param_count() - share.param_count() == \
        n_moe * 96 * 3 * d * ff
    # a token uses at most 8 of the share's 32 experts, as of the whole
    assert share.param_count() - share.active_param_count() == \
        n_moe * 24 * 3 * d * ff
    assert full.param_count() - full.active_param_count() == \
        n_moe * 120 * 3 * d * ff
    # a share of fewer than 8 experts: all of it active
    tiny = full.replace(experts_held=4)
    assert tiny.param_count() == tiny.active_param_count()


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b"])
def test_other_moe_configs_cur_their_2d_targets_only(arch):
    """Their targets leave out ``experts.*``: the expert stacks (a bare
    ``w_gate`` in a MoE layer) stay dense, as before."""
    from repro_torch.models import init_params
    cfg = get_smoke(arch)
    params = init_params(0, cfg, "cpu")
    calib = calibrate(params, cfg, [{"tokens": _tokens(6, (1, 16)) %
                                     cfg.vocab_size}])
    work = _cur_work_list(params, cfg, CURConfig(r_max=8), calib,
                          set(range(cfg.n_layers)))
    assert work and all(it.expert is None and it.W.dim() == 2
                        for it in work)
    want = [(li, t) for li, spec, lp in iter_layer_params(params, cfg)
            for t in cfg.cur_targets
            if t in lp and not isinstance(lp[t], dict) and lp[t].dim() == 2]
    assert [(it.layer, it.name) for it in work] == want
    assert all(n is None for n in calib.expert_tokens)
