"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block
(``repro.models.mamba``).

Training and prefill use the chunked SSD algorithm: quadratic
attention-like compute inside fixed-size chunks, a linear recurrence
between chunks (the JAX ``lax.scan`` over chunks is a Python loop here,
carrying the (B, nh, hp, N) state). Decode is the O(1) recurrent update.
All of it is plain PyTorch: the JAX package has no Pallas kernel here.

Projections are split (w_z, w_x, w_B, w_C, w_dt) as in the JAX package;
CURing targets w_x (the pre-SiLU branch), which ``apply_w`` runs through
``cur_matmul`` once folded.

Under a placed mesh (:func:`mamba_forward`'s ``mesh``, a
``repro_torch.dist.sharding.Placed`` of the layer) the in-projections are
column-parallel and ``w_out`` row-parallel. When the heads divide over
'model' the scan runs on this rank's heads: B and C (one group, shared
by every head) are all-gathered, the per-head params (conv_x, A_log, D,
dt_bias, the gate norm's scale) are sliced to this rank's heads, and the
gate norm's statistics over d_inner are summed over 'model'. Otherwise
the projections are all-gathered and the mixer runs whole on every rank,
which then feeds its block of the output to ``w_out``.

Cache writes are in place: the model's prefill / decode loop hands each
layer a view of its stacked cache and keeps no returned tensor, so
:func:`mamba_prefill` and :func:`mamba_decode` ``copy_`` the new conv
tails and state into the cache they are given (and return it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import model_dim
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import apply_w, out_local, rms_norm, to_input


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in the same form:
    max(x, 0) + log1p(exp(-|x|)). ``F.softplus`` returns x itself above
    its threshold 20, which differs from this by log1p(exp(-x)) < 2.1e-9
    there, far inside 2e-5; this form keeps the JAX formula everywhere."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B, S, C), w (K, C), b (C,)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i]
    return out + b


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan, in f32.

    xh (B, S, nh, hp) inputs per head; dt (B, S, nh) positive step sizes;
    A (nh,) negative decay rates; Bm / Cm (B, S, N) shared input / output
    projections (one group). Returns (y (B, S, nh, hp) in xh's dtype,
    final state (B, nh, hp, N) f32)."""
    Bsz, S, nh, hp = xh.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        # dt = 0 on padded steps: dA = 0 -> state unchanged, increment 0,
        # and the trailing outputs are dropped below
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S_orig, S = S, S + pad
    nc = S // c
    f32 = torch.float32

    x_c = xh.reshape(Bsz, nc, c, nh, hp).to(f32)
    dt_c = dt.reshape(Bsz, nc, c, nh).to(f32)
    B_c = Bm.reshape(Bsz, nc, c, N).to(f32)
    C_c = Cm.reshape(Bsz, nc, c, N).to(f32)

    dA = dt_c * A.to(f32)                                 # (B,nc,c,nh) <= 0
    dA_cum = torch.cumsum(dA, dim=2)

    # ---- intra-chunk (diagonal blocks) ----
    CB = torch.einsum("bzin,bzjn->bzij", C_c, B_c)        # (B,nc,c,c)
    causal = torch.ones(c, c, dtype=torch.bool, device=xh.device).tril()
    # the exponent is masked before exp (the JAX package masks W after):
    # the live entries are the same, and no exp of a positive sum past the
    # causal edge can overflow into the product or its gradient
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]
    seg = seg.masked_fill(~causal[None, None, :, :, None], float("-inf"))
    W = CB[..., None] * torch.exp(seg) * dt_c[:, :, None, :, :]
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", W, x_c)

    # ---- chunk summaries: the state each chunk gathers ----
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (B,nc,c,nh)
    states = torch.einsum("bzjn,bzjh,bzjhp->bzhpn",
                          B_c, decay_states * dt_c, x_c)     # (B,nc,nh,hp,N)

    # ---- inter-chunk recurrence: the state entering each chunk ----
    dA_sum = dA_cum[:, :, -1, :]                             # (B,nc,nh)
    h = (torch.zeros((Bsz, nh, hp, N), dtype=f32, device=xh.device)
         if initial_state is None else initial_state.to(f32))
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = h * torch.exp(dA_sum[:, z])[:, :, None, None] + states[:, z]
    h_in = torch.stack(h_in, dim=1)                          # (B,nc,nh,hp,N)

    # ---- inter-chunk contribution ----
    y_off = torch.einsum("bzin,bzhpn->bzihp", C_c, h_in)
    y_off = y_off * torch.exp(dA_cum)[..., None]
    y = (y_diag + y_off).reshape(Bsz, S, nh, hp)
    if pad:
        y = y[:, :S_orig]
    return y.to(xh.dtype), h


def _gate_out(y, z, p, cfg):
    """rms_norm(y * silu(z)) @ w_out, the block's output."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_z"]["scale"],
                 cfg.norm_eps)
    return apply_w(y, p["w_out"])


def _ssd(xb0, Bm0, Cm0, dt, p, cfg):
    """Convolutions, activations and the SSD scan of the projected inputs.
    Returns (y (B, S, di) before the gate, final state)."""
    B, S, _ = xb0.shape
    nh, hp = dt.shape[-1], cfg.ssm_head_dim     # this rank's heads
    xb = F.silu(_causal_conv(xb0, p["conv_x"], p["conv_x_b"]))
    Bm = F.silu(_causal_conv(Bm0, p["conv_B"], p["conv_B_b"]))
    Cm = F.silu(_causal_conv(Cm0, p["conv_C"], p["conv_C_b"]))
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())                       # (nh,)
    xh = xb.reshape(B, S, nh, hp)
    y, state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    return y.reshape(B, S, nh * hp), state


def _project(x, p):
    return (apply_w(x, p["w_z"]), apply_w(x, p["w_x"]), apply_w(x, p["w_B"]),
            apply_w(x, p["w_C"]), apply_w(x, p["w_dt"]))


def _mamba_in_placed(x, p, cfg, lay):
    """The in-projections on a rank's shards: ({name: activation}, whether
    the mixer runs on this rank's heads, the params as its heads take
    them). B and C are whole; on local heads z, x and dt are this rank's
    columns and the per-head params are sliced to its heads (see the
    module docstring)."""
    mesh = lay.mesh
    names = ("w_z", "w_x", "w_B", "w_C", "w_dt")
    ys = {k: apply_w(x, p[k], lay.spec(k), mesh) for k in names}
    local = {k: out_local(lay.spec(k)) for k in names}
    for k in ("w_B", "w_C"):
        if local[k]:
            ys[k] = col.gather(ys[k], -1, mesh, "model")
    heads = (cfg.ssm_heads % axis_sizes(mesh)["model"] == 0
             and local["w_z"] and local["w_x"] and local["w_dt"])
    q = dict(p)
    if heads:
        def mine(t):         # this rank's heads of a replicated leaf
            return col.scatter(t, -1, mesh, "model")

        def shared(t):       # whole on every rank, used by its heads only
            return col.copy_to(t, mesh, "model")

        for k in ("conv_x", "conv_x_b", "A_log", "D", "dt_bias"):
            q[k] = mine(p[k])
        for k in ("conv_B", "conv_B_b", "conv_C", "conv_C_b"):
            q[k] = shared(p[k])
        ys["w_B"], ys["w_C"] = shared(ys["w_B"]), shared(ys["w_C"])
    else:
        for k in ("w_z", "w_x", "w_dt"):
            if local[k]:
                ys[k] = col.gather(ys[k], -1, mesh, "model")
    return ys, heads, q


def _gate_placed(y, z, heads, p, cfg, lay):
    """rms_norm(y * silu(z)) @ w_out on a rank's shards: on local heads the
    norm's statistics over d_inner are summed over 'model'."""
    mesh = lay.mesh
    y = y * F.silu(z.float()).to(y.dtype)
    if heads:
        sq = torch.sum(torch.square(y.float()), dim=-1, keepdim=True)
        var = col.psum(sq, mesh, "model") / cfg.d_inner
        y = y * torch.rsqrt(var + cfg.norm_eps).to(y.dtype)
        y = y * col.scatter(p["norm_z"]["scale"], -1, mesh,
                            "model").to(y.dtype)
    else:
        y = rms_norm(y, p["norm_z"]["scale"], cfg.norm_eps)
    y = to_input(y, heads, lay.spec("w_out"), mesh)
    return apply_w(y, p["w_out"], lay.spec("w_out"), mesh)


def _mamba_placed(x, p, cfg, lay):
    """mamba_forward on a rank's shards (see the module docstring)."""
    ys, heads, q = _mamba_in_placed(x, p, cfg, lay)
    y, _ = _ssd(ys["w_x"], ys["w_B"], ys["w_C"], ys["w_dt"], q, cfg)
    return _gate_placed(y, ys["w_z"], heads, p, cfg, lay)


def _cache_dims(heads: bool):
    """The dim of each cache leaf that a rank's compute holds over
    'model' (None: whole): its heads' conv_x features and state heads on
    local heads; B and C's tails whole."""
    return {"conv_x": 2 if heads else None, "conv_B": None, "conv_C": None,
            "state": 1 if heads else None}


def _store(cache, new, heads, spec, mesh):
    """Write ``new`` (the compute's layout) into the cache shards."""
    for name, d in _cache_dims(heads).items():
        cache[name].copy_(col.relayout(new[name], d,
                                       model_dim(spec.get(name)), mesh))


def mamba_forward(x, p, cfg, *, return_state: bool = False, mesh=None):
    """Mamba-2 block. x (B, S, D) -> (B, S, D). ``mesh``: a ``Placed``
    of this layer's params (no ``return_state``)."""
    if mesh is not None:
        return _mamba_placed(x, p, cfg, mesh)
    z, xb0, Bm0, Cm0, dt = _project(x, p)
    y, state = _ssd(xb0, Bm0, Cm0, dt, p, cfg)
    out = _gate_out(y, z, p, cfg)
    if return_state:
        return out, state
    return out


def _tail(a, K):
    """The last K - 1 rows of a (B, S, C) pre-conv input, left-padded
    with zeros when S < K - 1."""
    pad = max(0, (K - 1) - a.shape[1])
    return F.pad(a, (0, 0, pad, 0))[:, -(K - 1):, :]


def mamba_prefill(x, p, cfg, cache, *, mesh=None, cache_spec=None):
    """Forward + recurrent-cache capture. Writes into ``cache`` in place
    the last K - 1 raw pre-conv inputs (left-padded with zeros when
    S < K - 1) and the final state. Returns (out, cache). ``mesh``: a
    ``Placed`` of this layer's params; ``cache`` is then this rank's
    shards per ``cache_spec`` (state heads, conv features over 'model'),
    which the rank writes from its heads' values or a block of the whole
    ones."""
    K = cfg.ssm_conv
    if mesh is not None:
        ys, heads, q = _mamba_in_placed(x, p, cfg, mesh)
        y, state = _ssd(ys["w_x"], ys["w_B"], ys["w_C"], ys["w_dt"], q, cfg)
        _store(cache, {"conv_x": _tail(ys["w_x"], K),
                       "conv_B": _tail(ys["w_B"], K),
                       "conv_C": _tail(ys["w_C"], K), "state": state},
               heads, cache_spec, mesh.mesh)
        return _gate_placed(y, ys["w_z"], heads, p, cfg, mesh), cache
    z, xb0, Bm0, Cm0, dt = _project(x, p)
    y, state = _ssd(xb0, Bm0, Cm0, dt, p, cfg)
    for name, t in (("conv_x", _tail(xb0, K)), ("conv_B", _tail(Bm0, K)),
                    ("conv_C", _tail(Cm0, K)), ("state", state)):
        cache[name].copy_(t)
    return _gate_out(y, z, p, cfg), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg, batch: int, dtype, device=None):
    """Conv tails in the model's dtype, the state in f32 (as in JAX)."""
    di, N, nh, hp = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    K = cfg.ssm_conv
    return {
        "conv_x": torch.zeros((batch, K - 1, di), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, K - 1, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, K - 1, N), dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, hp, N), dtype=torch.float32,
                             device=device),
    }


def _conv_step(x_t, cache, w, b):
    """x_t (B, C); cache (B, K-1, C) the last inputs. Returns (y_t, new
    tail)."""
    window = torch.cat([cache, x_t[:, None, :]], dim=1)      # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:, :]


def _recur(xb, Bm, Cm, dt, p, cfg, cache):
    """The recurrent update of one token's projected inputs xb (B, di),
    Bm / Cm (B, N), dt (B, nh) against ``cache`` (conv tails and state;
    a rank's heads when di and nh are its). Returns (y (B, di) in xb's
    dtype, {new conv tails, state})."""
    B = xb.shape[0]
    nh, hp = dt.shape[-1], cfg.ssm_head_dim
    dtype = xb.dtype
    xb, c_x = _conv_step(xb, cache["conv_x"], p["conv_x"], p["conv_x_b"])
    Bm, c_B = _conv_step(Bm, cache["conv_B"], p["conv_B"], p["conv_B_b"])
    Cm, c_C = _conv_step(Cm, cache["conv_C"], p["conv_C"], p["conv_C_b"])
    xb, Bm, Cm = F.silu(xb), F.silu(Bm), F.silu(Cm)

    dt = softplus(dt.float() + p["dt_bias"])                 # (B, nh)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                   # (B, nh)

    xh = xb.reshape(B, nh, hp).float()
    inc = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xh)
    state = cache["state"] * dA[:, :, None, None] + inc
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(B, nh * hp).to(dtype)
    return y, {"conv_x": c_x, "conv_B": c_B, "conv_C": c_C, "state": state}


def mamba_decode(x, p, cfg, cache, *, mesh=None, cache_spec=None):
    """Single-token recurrent update. x (B, 1, D) -> (B, 1, D); the conv
    tails and the state are written into ``cache`` in place. Returns
    (out, cache). ``mesh`` / ``cache_spec``: as :func:`mamba_prefill`'s
    (a leaf the compute holds whole is all-gathered over 'model')."""
    if mesh is not None:
        ys, heads, q = _mamba_in_placed(x[:, 0, :], p, cfg, mesh)
        m = mesh.mesh
        view = {name: col.relayout(cache[name],
                                   model_dim(cache_spec.get(name)), d, m)
                for name, d in _cache_dims(heads).items()}
        y, new = _recur(ys["w_x"], ys["w_B"], ys["w_C"], ys["w_dt"], q, cfg,
                        view)
        _store(cache, new, heads, cache_spec, m)
        out = _gate_placed(y, ys["w_z"], heads, p, cfg, mesh)
        return out[:, None, :], cache
    z, xb, Bm, Cm, dt = _project(x[:, 0, :], p)
    y, new = _recur(xb, Bm, Cm, dt, p, cfg, cache)
    out = _gate_out(y.to(x.dtype), z, p, cfg)[:, None, :]
    for name, t in new.items():
        cache[name].copy_(t)
    return out, cache
