"""The split-KV algebra of the port's paged-attention kernel, on the CPU.

``csrc/paged_attention.cu`` splits each (slot, kv-head)'s table into runs
of entries (``paged_attention.plan``), walks each run's live entries in
16-token pieces shared out among four warps, merges the warps of a query
tile and then the splits in a fixed order. This file computes those
partials with the TPU kernel's step-by-step arithmetic (f32 m and l,
NEG_INF masks, p rounded to the pool dtype before PV) in plain PyTorch,
merges them in the kernel's order, and holds the result against the JAX
op (interpret mode, as tests/test_torch_paged_attention.py runs it) and
the port's ``paged_attention_ref``, over tests/test_paged_attention.py's
case grid: ragged ctx, GQA/MHA/MQA, window < bs, q_span, an inactive slot
and splits with no live entry. Tolerances: 1e-5 f32 and 2e-2 bf16,
scale-relative (tests/test_paged_attention.py::_assert_close)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_attention_op as jax_op
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention.ref import (
    NEG_INF, paged_attention_ref)

from _torch_helpers import assert_close

torch.set_num_threads(1)

_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
_WARPS = 4


def _cdiv(a, b):
    return -(-a // b)


def _case(B, K, G, r, nb, bs, maxb, *, seed=0, inactive_last=True):
    """tests/test_paged_attention.py::_case with numpy draws."""
    rng = np.random.RandomState(seed)
    draw = np.random.RandomState(seed + 1000)
    q = draw.standard_normal((B, K, G, r)).astype(np.float32)
    kp = draw.standard_normal((nb, bs, K, r)).astype(np.float32)
    vp = draw.standard_normal((nb, bs, K, r)).astype(np.float32)
    ctx = np.array([rng.randint(0, maxb * bs) for _ in range(B)], np.int32)
    table = np.full((B, maxb), -1, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B):
        if inactive_last and b == B - 1:
            ctx[b] = 0
            continue
        for j in range(ctx[b] // bs + 1):
            table[b, j] = free.pop()
    return q, kp, vp, table, ctx


def _live(row, ctx, j0, j1, bs, window, span):
    """The TPU kernel's skip rule over entries j0 .. j1 - 1, in order."""
    out = []
    for j in range(j0, j1):
        ok = row[j] >= 0 and j * bs <= ctx + span - 1
        if window > 0:
            ok = ok and j * bs + bs - 1 > ctx - window
        if ok:
            out.append(j)
    return out


def _pieces(live, bs, ts):
    """The kernel's stages of ``ts`` token slots: whole entries when
    bs <= ts, else ``ts``-row chunks of one entry; each stage cut into
    16-slot pieces (global index, [(entry, row) or None] * 16), pieces past
    the stage's filled slots dropped."""
    cr = min(bs, ts)
    cpe, cps = _cdiv(bs, cr), ts // cr
    chunks = [(j, c) for j in live for c in range(cpe)]
    out = []
    for u, i0 in enumerate(range(0, len(chunks), cps)):
        st = chunks[i0:i0 + cps]
        slots = [None] * ts
        for ci, (j, c) in enumerate(st):
            for rr in range(cr):
                if c * cr + rr < bs:
                    slots[ci * cr + rr] = (j, c * cr + rr)
        for p in range(ts // 16):
            if 16 * p >= len(st) * cr:
                break
            out.append((u * (ts // 16) + p, slots[16 * p:16 * p + 16]))
    return out


def _warp_state(qt, kp, vp, tbl_row, kh, pieces, qpos, bs, window, dtype):
    """One warp's online softmax over its pieces, one step per piece as
    the TPU kernel's per-block step. qt (16, r) f32; qpos (16,)."""
    r = qt.shape[1]
    m = torch.full((16,), NEG_INF)
    lsum = torch.zeros(16)
    acc = torch.zeros(16, r)
    for slots in pieces:
        k = torch.zeros(16, r)
        v = torch.zeros(16, r)
        t = torch.full((16,), -1, dtype=torch.long)
        for i, sl in enumerate(slots):
            if sl is not None:
                j, row = sl
                k[i] = kp[tbl_row[j], row, kh]
                v[i] = vp[tbl_row[j], row, kh]
                t[i] = j * bs + row
        s = qt @ k.T                                       # (16, 16)
        ok = t[None] <= qpos[:, None]
        if window > 0:
            ok &= t[None] > qpos[:, None] - window
        s = torch.where(ok, s, torch.tensor(NEG_INF))
        s = torch.where(t[None] >= 0, s, torch.tensor(-float("inf")))
        m_new = torch.maximum(m, s.max(dim=1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        lsum = lsum * alpha + p.sum(dim=1)
        acc = acc * alpha[:, None] + p.to(dtype).float() @ v
        m = m_new
    return m, lsum, acc


def split_kernel_mirror(q, kp, vp, table, ctx, *, window, q_span, splits,
                        ts, dtype):
    """The kernel's result through its partials: f32 tensors in, (B, K,
    G, r) out in ``dtype``. ``splits``: the list of [j0, j1) runs."""
    B, K, G, r = q.shape
    bs = kp.shape[1]
    group = G // q_span
    mtiles = _cdiv(G, 16)
    q = q.to(dtype).float()
    kp, vp = kp.to(dtype).float(), vp.to(dtype).float()
    out = torch.zeros(B, K, G, r)
    for b in range(B):
        c = int(ctx[b])
        for kh in range(K):
            parts = []                       # (m, l, acc) per split
            for j0, j1 in splits:
                pcs = _pieces(_live(table[b], c, j0, j1, bs, window,
                                    q_span), bs, ts)
                M_rows, L_rows, A_rows = [], [], []
                for mt in range(mtiles):
                    rows = torch.arange(mt * 16, mt * 16 + 16)
                    qt = torch.zeros(16, r)
                    n = min(16, G - mt * 16)
                    qt[:n] = q[b, kh, mt * 16:mt * 16 + n]
                    qpos = c + rows // group
                    warps = [w for w in range(_WARPS) if w % mtiles == mt]
                    st = [_warp_state(qt, kp, vp, table[b], kh,
                                      [s for P, s in pcs
                                       if P % len(warps) == i],
                                      qpos, bs, window, dtype)
                          for i in range(len(warps))]
                    M = torch.full((16,), NEG_INF)
                    for m, _, _ in st:
                        M = torch.maximum(M, m)
                    L = torch.zeros(16)
                    A = torch.zeros(16, r)
                    for m, lsum, acc in st:          # warp order
                        f = torch.exp(m - M)
                        L = L + lsum * f
                        A = A + acc * f[:, None]
                    M_rows.append(M[:n])
                    L_rows.append(L[:n])
                    A_rows.append(A[:n])
                parts.append((torch.cat(M_rows), torch.cat(L_rows),
                              torch.cat(A_rows)))
            if len(parts) == 1:
                M, L, A = parts[0]
                out[b, kh] = A / torch.clamp(L, min=1e-30)[:, None]
                continue
            M = torch.full((G,), NEG_INF)
            for m, _, _ in parts:
                M = torch.maximum(M, m)
            L = torch.zeros(G)
            A = torch.zeros(G, r)
            for m, lsum, acc in parts:               # split order
                f = torch.exp(m - M)
                L = L + lsum * f
                # a split with l == 0 wrote no acc: it adds nothing
                f = torch.where(lsum != 0, f, torch.zeros_like(f))
                A = A + acc * f[:, None]
            out[b, kh] = A / torch.clamp(L, min=1e-30)[:, None]
    return out.to(dtype)


def _runs(maxb, eps):
    return [(j, min(j + eps, maxb)) for j in range(0, maxb, eps)]


def _check(arrays, *, window=0, q_span=1, dtype=torch.float32, sms=pa.SMS,
           eps_list=None):
    q, kp, vp, table, ctx = arrays
    B, K, G, r = q.shape
    bs, maxb = kp.shape[1], table.shape[1]
    p = pa.plan(B, K, G, r, bs, maxb, dtype, sms=sms)
    assert len(_runs(maxb, p.entries_per_split)) == p.splits
    t = [torch.from_numpy(a) for a in arrays]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    yj = np.asarray(jax_op(*[jnp.asarray(a).astype(jdt)
                             if a.dtype == np.float32 else jnp.asarray(a)
                             for a in arrays],
                           window=window, q_span=q_span), np.float32)
    yr = paged_attention_ref(*[x.to(dtype) if x.is_floating_point() else x
                               for x in t], window=window, q_span=q_span)
    dead = 0
    for eps in [p.entries_per_split] + list(eps_list or []):
        runs = _runs(maxb, eps)
        y = split_kernel_mirror(*t, window=window, q_span=q_span,
                                splits=runs, ts=p.stage_tokens, dtype=dtype)
        assert_close(y.float().numpy(), yj, _TOL[dtype])
        assert_close(y.float().numpy(), yr.float().numpy(), _TOL[dtype])
        for b in range(B):
            dead += sum(not _live(table[b], int(ctx[b]), j0, j1, bs, window,
                                  q_span) for j0, j1 in runs)
    return dead


@pytest.mark.parametrize("B,K,G,r,nb,bs,maxb,win", [
    (3, 2, 2, 16, 12, 4, 5, 0),     # GQA, ragged ctx
    (4, 4, 1, 8, 16, 8, 3, 0),      # MHA
    (2, 1, 4, 32, 8, 16, 2, 0),     # MQA
    (3, 2, 3, 16, 12, 4, 5, 7),     # sliding window
    (3, 2, 2, 16, 12, 4, 5, 3),     # window < block_size
])
def test_split_partials_match_jax_and_ref(B, K, G, r, nb, bs, maxb, win):
    arrays = _case(B, K, G, r, nb, bs, maxb)
    # the plan's split, then every split of the table into runs
    dead = _check(arrays, window=win, eps_list=range(1, maxb))
    assert dead > 0                 # the inactive slot's splits at least


@pytest.mark.parametrize("B,K,G,r,nb,bs,maxb,win,span", [
    (3, 2, 2, 16, 16, 4, 7, 0, 4),    # GQA, ragged ctx
    (2, 1, 4, 8, 12, 8, 4, 0, 2),     # MQA
    (3, 2, 3, 16, 16, 4, 7, 5, 3),    # sliding window
])
def test_split_partials_q_span(B, K, G, r, nb, bs, maxb, win, span):
    q, kp, vp, table, ctx = _case(B, K, span * G, r, nb, bs, maxb,
                                  inactive_last=False)
    ctx = np.maximum(np.minimum(ctx, (table >= 0).sum(1) * bs - span), 0
                     ).astype(np.int32)
    _check((q, kp, vp, table, ctx), window=win, q_span=span,
           eps_list=(1, 2, 3))


def test_split_partials_long_table_with_dead_splits():
    """A table long enough that the plan splits it (a small card), ragged
    contexts that leave whole splits dead, and rows past one m16 tile."""
    arrays = _case(3, 1, 20, 8, 120, 4, 40, seed=3)
    p = pa.plan(3, 1, 20, 8, 4, 40, torch.float32, sms=8)
    assert p.splits > 1
    assert _check(arrays, sms=8) > 0
    # a window that starts inside a split
    assert _check(arrays, window=9, sms=8) > 0


def test_split_partials_bf16():
    arrays = _case(2, 2, 2, 16, 24, 4, 10, seed=1)
    _check(arrays, dtype=torch.bfloat16, eps_list=(1, 3))


def test_split_partials_entries_longer_than_a_stage():
    """bs 128 > a stage's 64 tokens: an entry spans two stages."""
    arrays = _case(2, 1, 4, 8, 6, 128, 3, seed=2)
    p = pa.plan(2, 1, 4, 8, 128, 3, torch.float32)
    assert p.stage_tokens < 128
    _check(arrays, eps_list=(1, 2))
