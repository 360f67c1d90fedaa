"""Mesh builders over a ``torch.distributed`` world.

The torch counterpart of ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the JAX
package's axis names: ``("fleet", "model")`` for D-PSGD on real models
(node parameters shard their leading node axis over ``fleet``,
``train.shardings.node_param_specs``), ``("data", "model")`` for the host
and production meshes. One rank is one device: ``cuda:LOCAL_RANK`` under
NCCL on the card, a process under gloo on the CPU. ``init_world`` starts
the world from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from an explicit
``init_method`` (the tests' ``file://`` stores); the builders read the
world and never start one.

Building a mesh needs every rank of the world to call the builder (the
mesh makes one process group a dim). Each dim's group is
``mesh.get_group(name)``: a rank's place on the ``fleet`` dim is
``train.shardings.fleet_of(mesh)``, on the ``model`` dim (tensor
parallelism, the ranks of one node) ``models.tp.model_of(mesh)``; each
model coordinate has a fleet group of its own, whose ranks are not
contiguous in the world (``(fleet, model)`` is row-major: the fleet
group of model index m is ranks m, m + T, m + 2T, ...).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_world", "make_production_mesh", "make_host_mesh",
           "make_fleet_mesh", "replica_axes", "tp_size", "world_size"]


def init_world(device: str | torch.device = "cuda",
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.device:
    """Start this process's rank of the world and return its device.

    ``device`` ``"cuda"`` (or ``"cuda:k"``) runs the rank on
    ``cuda:LOCAL_RANK`` under NCCL, ``"cpu"`` under gloo: the backend
    follows the device, nothing falls back. ``rank`` / ``world_size``
    default to torchrun's ``RANK`` / ``WORLD_SIZE``; ``init_method``
    defaults to ``env://`` (torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``).
    """
    dev = torch.device(device)
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else int(world_size))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_world('cuda'): no CUDA device is available; pass "
                "device='cpu' for a gloo world on the host")
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"local rank {local} needs {local + 1} cards but only "
                f"{torch.cuda.device_count()} are visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method or "env://",
                                rank=rank, world_size=world_size,
                                device_id=dev)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    else:
        raise ValueError(f"no backend for device {str(dev)!r}")
    return dev


def world_size() -> int:
    """Ranks of the started world; 1 when none is started."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, axes: tuple, what: str):
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    avail = world_size()
    if n > avail:
        raise ValueError(
            f"{what} needs {'x'.join(map(str, shape))}={n} ranks but only "
            f"{avail} are in the world (start one rank a device: "
            f"torchrun --nproc_per_node {n})")
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: no torch.distributed world is started "
                           "(launch.mesh.init_world)")
    ranks = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 (256 ranks) or 2x16x16 (512 ranks) over the first ranks of
    the world; a smaller world raises, it is never reshaped."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "the production mesh")


def make_host_mesh(data: int = 4, model: int = 2):
    """A small (data, model) mesh for multi-rank host tests."""
    return _mesh((data, model), ("data", "model"), "the host mesh")


def make_fleet_mesh(fleet: int = 2, model: int = 2):
    """Mesh for D-PSGD on real models: node parameters shard their leading
    node axis over 'fleet' and each node's tensors over 'model' (the TP
    rules), so node count and model size scale independently.
    ``fleet * model`` must not exceed the world's ranks."""
    return _mesh((fleet, model), ("fleet", "model"), "fleet mesh")


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def replica_axes(mesh) -> tuple[str, ...]:
    """The D-PSGD node axes = every axis except 'model'."""
    return tuple(a for a in _axis_names(mesh) if a != "model")


def tp_size(mesh) -> int:
    """TP degree of the mesh — 1 when it carries no 'model' axis."""
    names = _axis_names(mesh)
    if "model" not in names:
        return 1
    if hasattr(mesh, "mesh_dim_names"):
        return int(mesh.size(names.index("model")))
    return int(mesh.shape["model"])
