"""The JAX package's side of tests/test_torch_dryrun.py, on 8 host
devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_jax_dryrun_ref.py OUT.pkl

Lowers and compiles each argument-bytes cell of tests/_dryrun_cases.py
with ``repro.launch.dryrun._compile_cell`` on a (2, 4) mesh (Auto axes)
and pickles ``memory_analysis().argument_size_in_bytes`` per cell. The
cells are jitted with ``keep_unused=True``, so that every argument is
counted, as the port counts the arguments its step takes (by default jit
drops an argument its program never reads: the cache that mamba's prefill
overwrites whole, the positions of an attention-free decode)."""
import functools
import os
import pickle
import sys

import jax

jax.jit = functools.partial(jax.jit, keep_unused=True)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dryrun_cases as dc  # noqa: E402

# the backend is up with the host devices above before repro.launch.dryrun
# sets its 512-device flag at import
jax.devices()

from repro.configs import get_smoke  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch import dryrun as jdr  # noqa: E402


def main(out_path):
    shape, axes = dc.MESH
    mesh = jax.make_mesh(shape, axes, axis_types=(
        jax.sharding.AxisType.Auto,) * len(axes))
    out = {}
    for arch, kind, paged, cur in dc.ARG_CELLS:
        compiled, _, _ = jdr._compile_cell(
            dc.smoke_cfg(get_smoke, arch), ShapeConfig(*dc.SHAPES[kind]),
            mesh, cur=cur, microbatch=0, paged=paged)
        out[(arch, kind, paged, cur)] = int(
            compiled.memory_analysis().argument_size_in_bytes)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
