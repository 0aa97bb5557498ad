"""Mesh construction (``repro.launch.mesh`` in the JAX package).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes:
``("data", "model")``, or ``("pod", "data", "model")`` across pods. Ranks
are laid out row-major over the axes (rank = data * n_model + model on the
2-D mesh), the order ``jax.make_mesh`` gives host devices. Building one is
collective: every rank of the default process group calls the same
function, which the caller has set up (``init_process_group`` with its
own store, world size and rank; NCCL on the card, gloo on the CPU).

A mesh places weights, optimizer state and caches per the layout specs
(``repro_torch.dist.sharding``: ``place`` gives each rank its shards, and
a ``Placed`` tells the model, the train step and the serving steps that
their inputs are such shards); the layers run explicit collectives over
its axes (``repro_torch.dist.collectives``).

:func:`fake_production_mesh` is the production mesh on torch's ``fake``
process-group backend as rank 0 of 256 (512): no devices and no peers,
for the dry run (``repro_torch.launch.dryrun``), whose collectives on
fake tensors move nothing.

:class:`AbstractMesh` is a mesh's shape and axis names with no devices,
for deriving the sharding rules of the production meshes (16 x 16 and 2 x
16 x 16) without 256 ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, without devices."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or an AbstractMesh, in axis
    order (``jax.sharding.Mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _device_type(device) -> str:
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod";
    needs a world of 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_local_mesh(shape, axes, device=device)


def fake_production_mesh(*, multi_pod: bool = False):
    """:func:`make_production_mesh` on a ``fake`` default process group of
    256 (512) ranks, this process rank 0, with a "cuda" device type (no
    card is touched: its collectives return at once). A default group that
    is already up is torn down first, so meshes of both sizes can follow
    one another (:func:`teardown`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes)


def fake_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A mesh of ``shape`` on a new ``fake`` default process group, this
    process rank 0 (see :func:`fake_production_mesh`)."""
    import torch.distributed as dist
    # the fake backend's store ships with PyTorch's test utilities only
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import DeviceMesh
    teardown()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh("cuda", ranks, mesh_dim_names=tuple(axes))


def teardown() -> None:
    """Destroy the default process group, if one is up."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def make_local_mesh(shape: Sequence[int] = (2, 2),
                    axes: Sequence[str] = ("data", "model"), device=None):
    """A mesh of ``shape`` over every rank of the default process group
    (whose world size must be the product of ``shape``)."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(_device_type(device), ranks,
                      mesh_dim_names=tuple(axes))


def make_recovery_mesh(plan, devices=None, device=None):
    """Mesh for an elastic restart: ``plan`` is a
    ``repro_torch.dist.elastic.RecoveryPlan``. Uses the first
    ``plan.active_chips`` of ``devices`` (healthy ranks; every rank of the
    world by default) as (data, model) = (new_data_parallel, tp_width);
    the remaining spares stay out of the mesh for the repair controller.
    Every rank of the world calls it, spares included."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if devices is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        devices = range(world)
    devices = list(devices)
    need = plan.active_chips
    if len(devices) < need:
        raise RuntimeError(
            f"recovery plan needs {need} devices, have {len(devices)}")
    ranks = torch.tensor(devices[:need]).reshape(
        plan.new_data_parallel, plan.tp_width)
    return DeviceMesh(_device_type(device), ranks,
                      mesh_dim_names=("data", "model"))
