"""Device meshes.

The production meshes are built by a function, never at import, over a
process group that the caller has started (``torch.distributed.
init_process_group`` with NCCL, one rank a card):

  single pod:   (data=16, model=16)           256 ranks
  two pods:     (pod=2, data=16, model=16)    512 ranks

``pod`` is an outer data-parallel axis, ``data`` carries the batch and
the FSDP shards of the weights, ``model`` the tensor-, expert- and
sequence-parallel shards (:mod:`repro_torch.distributed.sharding`).

:class:`MeshShape` is a mesh's axis names and sizes with no process
group behind it: the sharding rules accept it wherever they take a
mesh, so that the production layouts can be worked out on one host.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist


def production_shape(*, multi_pod: bool = False):
    """-> (shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


class MeshShape:
    """Axis names and sizes of a mesh, without devices: ``shape`` maps
    each axis name to its size, in mesh order (as a JAX mesh's does)."""

    def __init__(self, sizes: Tuple[int, ...], names: Tuple[str, ...]):
        assert len(sizes) == len(names), (sizes, names)
        self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(names, (int(s) for s in sizes)))


def _device_mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs a process group of "
            f"{n} ranks (have {have}): call torch.distributed."
            f"init_process_group first")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The production DeviceMesh on the cards (NCCL), one rank a card."""
    shape, names = production_shape(multi_pod=multi_pod)
    return _device_mesh("cuda", shape, names)


def make_host_mesh(n_data: int = 4, n_model: int = 2):
    """A ``(data, model)`` DeviceMesh on the CPU (gloo; tests)."""
    return _device_mesh("cpu", (n_data, n_model), ("data", "model"))


def make_mesh(shape, names, device_type: str = "cuda"):
    """A DeviceMesh of any ``shape`` and axis ``names`` over the started
    process group, on ``device_type`` (the cards unless asked)."""
    return _device_mesh(device_type, tuple(shape), tuple(names))


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes(mesh) -> tuple:
    """The data-parallel (batch) axes of a mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
