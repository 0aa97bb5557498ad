"""The port's side of tests/test_torch_dryrun.py, in a process of its own
(its fake default process group must not outlive it):

    python tests/_torch_dryrun_worker.py OUT.pkl

On a fake (2, 4) mesh it traces the argument-bytes cells and the
extrapolation cells of tests/_dryrun_cases.py (the fake tensors on the
CPU: this host's PyTorch may have no CUDA), and on a fake (1, 4) mesh one
TP-only SMOKE forward under the collectives' record; pickles the
results."""
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dryrun_cases as dc  # noqa: E402

import torch  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.mesh import fake_mesh, teardown  # noqa: E402


def _cell(arch, kind, paged, cur, mesh, extrapolate):
    return dr.lower_cell(
        arch, kind, mesh=mesh, cfg=dc.smoke_cfg(get_smoke, arch),
        shape=ShapeConfig(*dc.SHAPES[kind]), paged=paged, cur=cur,
        extrapolate=extrapolate, device="cpu", verbose=False)


def _tp_forward():
    """The collectives' record of one SMOKE forward on placed fake params
    over a (1, 4) mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist import collectives as col
    from repro_torch.dist.sharding import Placed, param_pspecs
    from repro_torch.launch import specs as sp
    from repro_torch.models import forward
    mesh = fake_mesh(*dc.TP_MESH)
    arch, B, S = dc.TP_FORWARD
    cfg = get_smoke(arch)
    params_m = sp.param_specs(cfg)
    specs = param_pspecs(params_m, cfg, mesh)
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        params = dr._fake(params_m, specs, mesh, "cpu")
        tokens = torch.empty((B, S), dtype=torch.int32)
        with col.recording() as rec:
            forward(params, cfg, {"tokens": tokens}, Placed(mesh, specs))
    return dict(rec)


def main(out_path):
    mesh = fake_mesh(*dc.MESH)
    out = {"args": {}, "extrap": {}}
    try:
        for case in dc.ARG_CELLS:
            out["args"][case] = _cell(*case, mesh, False)
        for arch, kind, paged in dc.EXTRAP_CELLS:
            out["extrap"][(arch, kind, paged)] = tuple(
                _cell(arch, kind, paged, False, mesh, e) for e in (True,
                                                                   False))
        out["tp"] = _tp_forward()
    finally:
        teardown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
