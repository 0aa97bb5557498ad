"""Faults planted under the CURing cell's timed path, each in one stage of
the program's compression; the check has to read each one above its
limit. ``FAULTS[name] = (plant, number)``: ``plant(setattr)`` patches the
program through a ``setattr(obj, name, value)`` that its caller undoes
(pytest's ``monkeypatch.setattr``, or ``Patch`` below), and ``number``
is the check's number that the fault has to fail.
"""
import torch


class Patch:
    """``setattr`` that remembers what it replaced; ``undo()`` restores."""

    def __init__(self):
        self._undo = []

    def __call__(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


def fold_skipped(patch):
    """The fold writes C where C U belongs (an answer altered)."""
    from repro_torch.core import compress
    patch(compress, "fold_cur",
          lambda leaf: {"CU": leaf["C"], "R": leaf["R"]})


def index_altered(patch):
    """DEIM's row indices are reported one row off."""
    from repro_torch.core import compress
    orig = compress._compress_batched

    def shifted(work, cur_cfg):
        out = orig(work, cur_cfg)
        for leaf, info in out:
            info.rows = (info.rows + 1) % info.shape[0]
        return out
    patch(compress, "_compress_batched", shifted)


def half_batch(patch):
    """Only the first half of each shape-class's weights is compressed."""
    from repro_torch.core import compress
    orig = compress._compress_batched

    def half(work, cur_cfg):
        out = orig(work, cur_cfg)
        return [(leaf, info) if i < max(1, len(out) // 2) else
                (leaf, info.__class__(**{**info.__dict__,
                                         "params_after": info.params_before}))
                for i, (leaf, info) in enumerate(out)]
    patch(compress, "_compress_batched", half)


def deim_without_interpolation(patch):
    """DEIM picks, for singular vector j, its largest entry among the rows
    not yet picked, skipping the interpolation residual: the selection
    itself changes, and R, C U and the reported indices stay consistent."""
    from repro_torch.core import compress

    def leverage(V):
        V = V.float()
        lead, (m, r) = V.shape[:-2], V.shape[-2:]
        Vb = V.reshape(-1, m, r).abs()
        k = Vb.shape[0]
        p = torch.zeros((k, r), dtype=torch.long, device=V.device)
        seen = torch.zeros((k, m), dtype=torch.bool, device=V.device)
        ar = torch.arange(k, device=V.device)
        for j in range(r):
            pj = torch.argmax(torch.where(seen, -1.0, Vb[:, :, j]), dim=-1)
            p[:, j] = pj
            seen[ar, pj] = True
        return p.reshape(*lead, r)
    patch(compress, "deim", leverage)


def wanda_without_activations(patch):
    """The WANDA score leaves out the activation norms (S = |W|)."""
    from repro_torch.core import compress
    patch(compress, "wanda_scores", lambda W, act_sq: W.float().abs())


def randomized_svd(patch):
    """The program's randomized range finder (two power iterations) runs
    where the exact SVD is asked for."""
    from repro_torch.core import compress, cur

    def rsvd(S, r):
        g = torch.Generator(device=S.device).manual_seed(0)
        return cur.randomized_svd(S, r, generator=g)
    patch(compress, "exact_svd", rsvd)


FAULTS = {
    "fold_skipped": (fold_skipped, "fold_gap"),
    "index_altered": (index_altered, "deim_gap"),
    "half_batch": (half_batch, "weights_missing"),
    "deim_without_interpolation": (deim_without_interpolation, "deim_gap"),
    "wanda_without_activations": (wanda_without_activations, "wanda_gap"),
    "randomized_svd": (randomized_svd, "svd_gap"),
}
