"""Production mesh definition (the reference's ``launch/mesh.py``).

Functions, not module constants: importing this module touches no device
and no process group.  Each builds a ``DeviceMesh`` over the default
process group, whose world size must be the mesh's size: torchrun's group
on a cluster, or the ``fake`` group the dry run makes
(:func:`fake_process_group`), whose collectives move no data.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_test_mesh", "batch_shards", "axis_size", "fake_process_group"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) over ``("data", "model")``, or with ``multi_pod`` (2, 16, 16)
    over ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), *, device_type: str = "cuda") -> DeviceMesh:
    """A small mesh for sharding tests."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of the mesh dim ``name``, 1 when the mesh has none."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.shape[names.index(name)]) if name in names else 1


def batch_shards(mesh: DeviceMesh) -> int:
    """Total shards along the batch-like axes (pod × data)."""
    return axis_size(mesh, "pod") * axis_size(mesh, "data")


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A default process group of ``world_size`` ranks, this process rank 0,
    whose collectives return at once without moving data (PyTorch's
    ``fake`` backend): enough to build a mesh of that size and trace one
    rank's program.  Refuses to stack on a live default group; destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
