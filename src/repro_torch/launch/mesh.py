"""Production and host meshes.

Counterpart of `repro.launch.mesh`. A FUNCTION, not a module-level
constant: importing this module touches no device or process group.
The production meshes are abstract (axis names and sizes, no devices):
the reference builds them over 512 fake host devices for its dry-run,
which only reads their shape. The host mesh is a `DeviceMesh` over the
initialised process group, one rank a device.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.parallel.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16,16)=(data,model) single pod (256 chips) or (2,16,16)=
    (pod,data,model) for 2 pods = 512 chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(model: int = 1):
    """A (world // model, model) ("data", "model") `DeviceMesh` over the
    initialised process group: of cards under NCCL (one a rank), of CPU
    processes under gloo. Without a group, the abstract (1, 1) mesh: one
    device, where every sharding rule resolves to replication."""
    if not (dist.is_available() and dist.is_initialized()):
        return AbstractMesh((1, 1), ("data", "model"))
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    model = min(model, n)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
