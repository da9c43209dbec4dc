"""Device meshes over the current process group; mirrors
``repro.launch.mesh``.

Functions, never module constants: importing this module touches no
process group or device.  Each builds a ``DeviceMesh`` with
``torch.distributed.device_mesh.init_device_mesh`` over the default
process group, which must already hold ``prod(shape)`` ranks: ``"cuda"``
meshes on NCCL, ``"cpu"`` ones on gloo or on the dry-run's fake world.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from ..distributed.partition import axis_size


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A mesh of ``shape`` over ``axes`` on the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(16, 16) over ("data", "model"): 256 devices; with ``multi_pod``
    (2, 16, 16) with "pod" first: 512."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(multi_pod: bool = False):
    return make_mesh(*production_shape(multi_pod))


def make_host_mesh(data: int = 2, model: int = 4):
    """A small (data, model) mesh, as multi-rank tests use."""
    return make_mesh((data, model), ("data", "model"))


def mesh_axis_size(mesh, name: str) -> int:
    return axis_size(mesh, name)
