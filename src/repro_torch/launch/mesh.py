"""Device meshes: axis names and shape, and for a live one its process groups.

Counterpart of ``repro/launch/mesh.py``.  Functions, not module-level
constants, so importing this module touches no device and no process group.

    single-pod : (16, 16)    axes ("data", "model")
    multi-pod  : (2, 16, 16) axes ("pod", "data", "model")

A live mesh holds a ``torch.distributed`` ``DeviceMesh`` over the process
group the caller started (``torch.distributed.init_process_group``: NCCL on
the card, gloo on the CPU); a world of one with no group holds none, and its
collectives are skipped.  A production mesh is abstract: its names and shape
serve the sharding rules and the dry run, and no step runs on it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device_mesh: Optional[Any] = None  # torch.distributed.device_mesh.DeviceMesh

    def axis_size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 without a group)."""
        if self.device_mesh is None or axis not in self.axis_names:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group along ``axis``, or None without a group."""
        if self.device_mesh is None or axis not in self.axis_names:
            return None
        return self.device_mesh.get_group(axis)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_local_mesh(n_devices: int = 1, model_parallel: int = 1) -> Mesh:
    """A ("data", "model") mesh over the live process group's ranks, data
    outermost: rank r sits at (r // model_parallel, r % model_parallel).
    The group runs on the device type its backend serves (NCCL: "cuda")."""
    data = max(1, n_devices // model_parallel)
    shape = (data, model_parallel)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model_parallel != world:
        raise ValueError(f"a {shape} mesh needs a world of {data * model_parallel} ranks; the live world has {world}")
    if not dist.is_initialized():
        return Mesh(("data", "model"), shape)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, shape, mesh_dim_names=("data", "model"))
    return Mesh(("data", "model"), shape, dm)
