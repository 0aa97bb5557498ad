"""Port parity for the sharding rules, the shape stand-ins, the abstract
mesh and elastic recovery (one process, no ranks).

Every spec tree of ``repro_torch.dist.sharding`` equals the JAX package's
(each PartitionSpec as a tuple), for every arch on both production meshes
(16 x 16 and 2 x 16 x 16, abstract): params, their CUR and folded CUR
forms, optimizer state (f32 and int8 moments), dense caches at every
applicable shape, paged pools (kernel on / off, CUR-KV), batches, decode
inputs and paged decode inputs. ``repro_torch.launch.specs``'s stand-ins
have the shapes and dtypes of JAX's ``eval_shape`` results and the same
parameter counts. These are the cases of tests/test_sharding.py, held
against JAX's output rather than re-asserted."""
import functools

import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import CURConfig as JaxCURConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.dist import sharding as jshd
from repro.dist.elastic import plan_recovery as jax_plan_recovery
from repro.launch import specs as jsp
from repro.optim.adamw import AdamW as JaxAdamW
from repro.serving.paged_cache import PagedConfig as JaxPagedConfig
from repro.serving.paged_cache import init_paged_cache as jax_paged_cache
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke
from repro_torch.configs.base import CURConfig, OptimizerConfig
from repro_torch.configs.base import shape_applicable
from repro_torch.dist import sharding as tshd
from repro_torch.dist.elastic import plan_recovery
from repro_torch.launch import specs as tsp
from repro_torch.launch.mesh import make_recovery_mesh
from repro_torch.optim.adamw import AdamW
from repro_torch.serving.paged_cache import PagedConfig, init_paged_cache

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_CASES = [(a, s) for a in ARCHS for s, sh in SHAPES.items()
               if sh.kind != "train" and shape_applicable(a, sh)]


def _meshes(name):
    shape, axes = MESHES[name]
    return jshd.abstract_mesh(shape, axes), tshd.abstract_mesh(shape, axes)


def _specs(tree):
    """A spec tree with every PartitionSpec as a plain tuple."""
    if isinstance(tree, (jax.sharding.PartitionSpec, tshd.PartitionSpec)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_specs(v) for v in tree]
    return tree


def _shapes(tree):
    """(shape, dtype name) of every stand-in, in the tree's layout."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    if tree is None or not hasattr(tree, "shape"):
        return tree
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX config, JAX param stand-ins, port config, port stand-ins)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    return jcfg, jsp.param_specs(jcfg), cfg, tsp.param_specs(cfg)


def _same(jtree, ttree):
    assert _specs(ttree) == _specs(jtree)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, jp, cfg, tp = _params(arch)
    _same(jshd.param_pspecs(jp, jcfg, jm), tshd.param_pspecs(tp, cfg, tm))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cur_param_pspecs_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, jp, cfg, tp = _params(arch)
    jc = jsp.structural_cur(jp, jcfg, JaxCURConfig())
    tc = tsp.structural_cur(tp, cfg, CURConfig())
    _same(jshd.param_pspecs(jc, jcfg, jm), tshd.param_pspecs(tc, cfg, tm))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_folded_cur_param_pspecs_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, jp, cfg, tp = _params(arch)
    jf = jsp.fold_cur_struct(jsp.structural_cur(jp, jcfg, JaxCURConfig()))
    tf = tsp.fold_cur_struct(tsp.structural_cur(tp, cfg, CURConfig()))
    _same(jshd.param_pspecs(jf, jcfg, jm), tshd.param_pspecs(tf, cfg, tm))


@pytest.mark.parametrize("arch", ARCHS)
def test_draft_param_pspecs_match_jax(arch):
    """A harder-compressed draft's low ranks fail the guard alike."""
    jm, tm = _meshes("16x16")
    jcfg, jp, cfg, tp = _params(arch)
    jd = jsp.structural_cur(jp, jcfg, JaxCURConfig(r_max=8))
    td = tsp.structural_cur(tp, cfg, CURConfig(r_max=8))
    _same(jshd.draft_param_pspecs(jd, jcfg, jm),
          tshd.draft_param_pspecs(td, cfg, tm))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_pspecs_match_jax(arch, mesh, quantized):
    jm, tm = _meshes(mesh)
    jcfg, jp, cfg, tp = _params(arch)
    jstate = jax.eval_shape(
        JaxAdamW(JaxOptimizerConfig(quantized_state=quantized)).init, jp)
    tstate = AdamW(OptimizerConfig(quantized_state=quantized)).init(tp)
    assert _shapes(tstate) == _shapes(jstate)
    _same(jshd.opt_state_pspecs(jstate, jcfg, jm),
          tshd.opt_state_pspecs(tstate, cfg, tm))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CACHE_CASES)
def test_cache_pspecs_match_jax(arch, shape, mesh):
    jm, tm = _meshes(mesh)
    jcfg, _, cfg, _ = _params(arch)
    jshape, tshape = JAX_SHAPES[shape], SHAPES[shape]
    jc, tc = jsp.cache_specs(jcfg, jshape), tsp.cache_specs(cfg, tshape)
    assert _shapes(tc) == _shapes(jc)
    _same(jshd.cache_pspecs(jc, jcfg, jshape, jm),
          tshd.cache_pspecs(tc, cfg, tshape, tm))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_cache_pspecs_match_jax(arch, mesh):
    """The decode_32k pool, kernel on and off, and a CUR-KV pool at rank
    64 (its projections replicate)."""
    jm, tm = _meshes(mesh)
    jcfg, _, cfg, _ = _params(arch)
    jpool, jpc = jsp.paged_cache_specs(jcfg, JAX_SHAPES["decode_32k"])
    tpool, tpc = tsp.paged_cache_specs(cfg, SHAPES["decode_32k"])
    assert _shapes(tpool) == _shapes(jpool)
    for kernel in (False, True):
        _same(jshd.paged_cache_pspecs(jpool, jcfg, jm, kernel=kernel),
              tshd.paged_cache_pspecs(tpool, cfg, tm, kernel=kernel))
    kw = dict(block_size=128, n_blocks=64, max_blocks_per_seq=8,
              cur_kv=True, kv_rank=64)
    jcur = jax.eval_shape(lambda: jax_paged_cache(jcfg, JaxPagedConfig(**kw)))
    tcur = init_paged_cache(cfg, PagedConfig(**kw), "meta")
    # the port keeps the CUR-KV column indices as int64 (torch's index
    # dtype) where JAX keeps int32: their shapes are held equal
    assert {k: _shapes(tcur[k]) for k in ("k", "v")} == \
        {k: _shapes(jcur[k]) for k in ("k", "v")}
    assert {k: tuple(v.shape) for k, v in tcur["proj"].items()} == \
        {k: tuple(v.shape) for k, v in jcur["proj"].items()}
    for kernel in (False, True):
        _same(jshd.paged_cache_pspecs(jcur, jcfg, jm, kernel=kernel),
              tshd.paged_cache_pspecs(tcur, cfg, tm, kernel=kernel))


def test_paged_cache_pspecs_kernel_pins_kv_heads():
    """SMOKE olmo's 4 kv-heads do not divide 16: the einsum path falls
    back to the rank axis, the kernel path replicates, in both packages."""
    jm, tm = _meshes("16x16")
    kw = dict(block_size=16, n_blocks=64, max_blocks_per_seq=8)
    jcfg, cfg = jax_get_smoke("olmo-1b"), get_smoke("olmo-1b")
    jpool = jax.eval_shape(lambda: jax_paged_cache(jcfg, JaxPagedConfig(**kw)))
    tpool = init_paged_cache(cfg, PagedConfig(**kw), "meta")
    for kernel in (False, True):
        j = jshd.paged_cache_pspecs(jpool, jcfg, jm, kernel=kernel)
        t = tshd.paged_cache_pspecs(tpool, cfg, tm, kernel=kernel)
        _same(j, t)
    assert tuple(tshd.paged_cache_pspecs(tpool, cfg, tm)["k"]) == (
        None, None, None, None, "model")
    assert tshd.paged_cache_pspecs(tpool, cfg, tm, kernel=True)["k"] is None


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_pspecs_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, _, cfg, _ = _params(arch)
    for name, shape in SHAPES.items():
        js = JAX_SHAPES[name]
        _same(jshd.batch_pspecs(jcfg, js, jm),
              tshd.batch_pspecs(cfg, shape, tm))
        _same(jshd.decode_batch_pspecs(jcfg, js, jm),
              tshd.decode_batch_pspecs(cfg, shape, tm))
        for kernel in (False, True):
            for batch, maxb in ((shape.global_batch, 256), (1, 8), (48, 3)):
                _same(jshd.paged_decode_pspecs(jcfg, batch, maxb, jm,
                                               kernel=kernel),
                      tshd.paged_decode_pspecs(cfg, batch, maxb, tm,
                                               kernel=kernel))


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_match_eval_shape(arch):
    """launch/specs: inputs, decode inputs, params, caches, paged pools
    and their decode inputs, structural CUR and its folded form: shapes,
    dtypes and parameter counts equal JAX's."""
    jcfg, jp, cfg, tp = _params(arch)
    assert _shapes(tp) == _shapes(jp)
    assert tsp.count_struct_params(tp) == jsp.count_struct_params(jp)
    for r_max in (64, 256):
        jc = jsp.structural_cur(jp, jcfg, JaxCURConfig(r_max=r_max))
        tc = tsp.structural_cur(tp, cfg, CURConfig(r_max=r_max))
        assert _shapes(tc) == _shapes(jc)
        assert tsp.count_struct_params(tc) == jsp.count_struct_params(jc)
        jf, tf = jsp.fold_cur_struct(jc), tsp.fold_cur_struct(tc)
        assert _shapes(tf) == _shapes(jf)
        assert tsp.count_struct_params(tf) == jsp.count_struct_params(jf)
    for name, shape in SHAPES.items():
        js = JAX_SHAPES[name]
        assert _shapes(tsp.input_specs(cfg, shape)) == _shapes(
            jsp.input_specs(jcfg, js))
        assert _shapes(tsp.decode_input_specs(cfg, shape)) == _shapes(
            jsp.decode_input_specs(jcfg, js))
        assert tsp.paged_config_for(shape, 64).__dict__ == \
            jsp.paged_config_for(js, 64).__dict__
        if shape.kind != "train" and shape_applicable(arch, shape):
            assert _shapes(tsp.cache_specs(cfg, shape)) == _shapes(
                jsp.cache_specs(jcfg, js))
    shape, js = SHAPES["decode_32k"], JAX_SHAPES["decode_32k"]
    tpool, tpc = tsp.paged_cache_specs(cfg, shape)
    jpool, jpc = jsp.paged_cache_specs(jcfg, js)
    assert _shapes(tpool) == _shapes(jpool)
    assert _shapes(tsp.paged_decode_input_specs(cfg, shape, tpc)) == \
        _shapes(jsp.paged_decode_input_specs(jcfg, js, jpc))
    assert all(t.device.type == "meta" for t in tsp.input_specs(
        cfg, shape).values())


def test_structural_cur_reduces_params():
    """tests/test_sharding.py's case: deepseek-67b's wq (8192, 8192) at
    r_max 256 is CURed in all 95 layers."""
    cfg = get_config("deepseek-67b")
    dense = tsp.param_specs(cfg)
    cur = tsp.structural_cur(dense, cfg, CURConfig(r_max=256))
    assert tsp.count_struct_params(cur) < tsp.count_struct_params(dense)
    blk = cur["groups"][0][0]
    assert set(blk["wq"]) == {"C", "U0", "dU", "R"}
    assert tuple(blk["wq"]["U0"].shape) == (95, 256, 256)


def test_tp_sharding_assignments():
    """The layout contract's spot checks (tests/test_sharding.py)."""
    P = tshd.P
    _, tm = _meshes("16x16")
    cfg = get_config("deepseek-67b")                # fsdp=True
    blk = tshd.param_pspecs(_params("deepseek-67b")[3], cfg, tm)
    assert blk["groups"][0][0]["wq"] == P(None, "data", "model")
    assert blk["groups"][0][0]["wo"] == P(None, "model", "data")
    assert blk["embed"] == P("model", None)
    kimi = get_config("kimi-k2-1t-a32b")
    ks = tshd.param_pspecs(_params("kimi-k2-1t-a32b")[3], kimi, tm)
    assert ks["groups"][1][0]["w_gate"] == P(None, "model", "data", None)
    mix = get_config("mixtral-8x22b")
    ms = tshd.param_pspecs(_params("mixtral-8x22b")[3], mix, tm)
    assert ms["groups"][0][0]["w_gate"] == P(None, None, "data", "model")


@pytest.mark.parametrize("total,failed,tp,step", [
    (512, 16, 16, 7), (256, 0, 16, 0), (8, 2, 2, 3), (8, 3, 2, 1),
    (1, 0, 1, 0), (64, 47, 16, 2), (16, 1, 4, 9)])
def test_plan_recovery_matches_jax(total, failed, tp, step):
    kw = dict(total_chips=total, failed_chips=failed, tp_width=tp,
              resume_step=step)
    want = jax_plan_recovery(**kw)
    got = plan_recovery(**kw)
    assert got.__dict__ == want.__dict__
    assert got.active_chips == want.active_chips


@pytest.mark.parametrize("total,failed,tp", [(8, 9, 2), (8, -1, 2),
                                             (16, 10, 8)])
def test_plan_recovery_refuses_like_jax(total, failed, tp):
    kw = dict(total_chips=total, failed_chips=failed, tp_width=tp,
              resume_step=0)
    with pytest.raises((ValueError, RuntimeError)) as want:
        jax_plan_recovery(**kw)
    with pytest.raises(want.type):
        plan_recovery(**kw)


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_recovery_mesh_from_plan(world_of_one):
    """tests/test_sharding.py's case on a world of one rank: a 1 x 1
    (data, model) mesh, and a plan for 256 chips refused."""
    plan = plan_recovery(total_chips=1, failed_chips=0, tp_width=1,
                         resume_step=0)
    m = make_recovery_mesh(plan, device="cpu")
    assert tuple(m.shape) == (1, 1)
    assert m.mesh_dim_names == ("data", "model")
    big = plan_recovery(total_chips=512, failed_chips=16, tp_width=16,
                        resume_step=7)
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        make_recovery_mesh(big, device="cpu")


def test_abstract_mesh():
    _, tm = _meshes("2x16x16")
    assert tm.shape == {"pod": 2, "data": 16, "model": 16}
    assert tm.axis_names == ("pod", "data", "model")


@pytest.mark.parametrize("spec,want", [
    (None, ("R", "R", "R")),
    (("data", None), ("R", "S(0)", "R")),
    ((("pod", "data"), "model"), ("S(0)", "S(0)", "S(1)")),
    (("model", ("pod", "data")), ("S(1)", "S(1)", "S(0)")),
])
def test_to_placements(spec, want):
    """Spec entries (tensor dim -> mesh axes) become placements (mesh dim
    -> tensor dim); a multi-axis entry shards on each of its axes."""
    _, tm = _meshes("2x16x16")
    spec = None if spec is None else tshd.P(*spec)
    assert tuple(str(p) for p in tshd.to_placements(spec, tm)) == want


def test_to_placements_refuses_minor_first():
    _, tm = _meshes("2x16x16")
    with pytest.raises(ValueError, match="mesh order"):
        tshd.to_placements(tshd.P(("data", "pod")), tm)


def test_port_stand_ins_hold_no_memory():
    """param_specs of the 1T-parameter kimi config: meta tensors only,
    and nothing drawn (it takes no generator)."""
    tp = _params("kimi-k2-1t-a32b")[3]
    leaves = [t for t in jax.tree.leaves(
        tsp.fold_cur_struct(tp), is_leaf=lambda x: isinstance(
            x, torch.Tensor))]
    assert leaves and all(t.is_meta for t in leaves)
    assert tsp.count_struct_params(tp) > 10**12


# ---------------------------------------------------------------------------
# CUR dispatch under a mesh, placement on entry
# ---------------------------------------------------------------------------

def _one_mesh():
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh((1, 1), ("data", "model"), device="cpu")


@pytest.fixture
def kernel_gate(monkeypatch):
    """The folded-CUR kernel gate open on the CPU, and cur_matmul_op's
    calls recorded (its CPU version is the plain chain, and it raises for
    an input that requires a gradient, as on the card)."""
    from repro_torch.kernels.cur_matmul import ops
    from repro_torch.models import layers
    calls = []
    real = ops.cur_matmul_op

    def op(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(layers, "use_cur_kernel", lambda *a, **k: True)
    monkeypatch.setattr(ops, "cur_matmul_op", op)
    return calls


@pytest.mark.parametrize("case", ["no_grad", "grad_mode", "folded_trains",
                                  "healing_trains"])
def test_placed_column_parallel_cur_dispatches_as_on_one_device(
        world_of_one, kernel_gate, case):
    """A column-parallel CUR weight under a mesh takes cur_matmul where
    the one-device path does: in inference (grad mode on or off) the
    kernel runs on the local R; a folded weight that requires a gradient
    raises in both; the healing form trains through the chain, its
    gradients the one-device ones."""
    from repro_torch.models.layers import apply_w
    from repro_torch.dist.sharding import P
    mesh = _one_mesh()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 64, generator=g)
    if case == "healing_trains":
        w = {"C": torch.randn(64, 16, generator=g),
             "U0": torch.randn(16, 16, generator=g),
             "dU": torch.zeros(16, 16), "R": torch.randn(16, 48, generator=g)}
        spec = {"C": None, "U0": None, "dU": None, "R": P(None, "model")}
    else:
        w = {"CU": torch.randn(64, 16, generator=g),
             "R": torch.randn(16, 48, generator=g)}
        spec = {"CU": None, "R": P(None, "model")}
    want = apply_w(x, w)
    n_one = len(kernel_gate)
    if case == "no_grad":
        with torch.no_grad():
            got = apply_w(x, w, spec, mesh)
    elif case == "grad_mode":
        got = apply_w(x, w, spec, mesh)
    elif case == "folded_trains":
        w = {k: v.requires_grad_() for k, v in w.items()}
        for m in ((), (spec, mesh)):
            with pytest.raises(RuntimeError, match="requires grad"):
                apply_w(x, w, *m)
        return
    else:
        leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
        one = {k: v.clone().requires_grad_() for k, v in w.items()}
        got = apply_w(x, leaves, spec, mesh)
        apply_w(x, one).square().sum().backward()
        got.square().sum().backward()
        for k in w:
            torch.testing.assert_close(leaves[k].grad, one[k].grad,
                                       rtol=2e-5, atol=2e-5)
        assert len(kernel_gate) == 0
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    if case in ("no_grad", "grad_mode"):
        assert len(kernel_gate) == 2 * n_one == 2


def test_plain_mesh_is_placed_on_entry(world_of_one):
    """Under a plain DeviceMesh the entry points place whole params on
    entry: forward, loss_fn, forward_hidden and generate give the
    one-device results (mixtral SMOKE, a2a body, 1 x 1 mesh), and params
    that require a gradient are refused."""
    from repro_torch.models import forward, forward_hidden, init_params
    from repro_torch.models import loss_fn
    from repro_torch.serve import generate
    mesh = _one_mesh()
    cfg = get_smoke("mixtral-8x22b").replace(moe_impl="a2a",
                                             capacity_factor=8.0,
                                             dtype="float32")
    p = init_params(0, cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    b = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        torch.testing.assert_close(forward(p, cfg, b, mesh),
                                   forward(p, cfg, b), rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(loss_fn(p, cfg, b, mesh),
                                   loss_fn(p, cfg, b), rtol=2e-5, atol=2e-5)
        for a, c in zip(forward_hidden(p, cfg, b, mesh),
                        forward_hidden(p, cfg, b)):
            torch.testing.assert_close(a, c, rtol=2e-5, atol=2e-5)
    assert torch.equal(generate(p, cfg, toks[:, :8], 4, mesh=mesh).tokens,
                       generate(p, cfg, toks[:, :8], 4).tokens)
    p["final_norm"]["scale"].requires_grad_()
    with pytest.raises(ValueError, match="plain DeviceMesh"):
        loss_fn(p, cfg, b, mesh)
