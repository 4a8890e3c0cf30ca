"""Process groups and device meshes for the port's scale-out path.

Port of ``videoquery/core/meshes.py``. The JAX package runs one SPMD
program over a ``jax.sharding.Mesh``; here each process owns one device and
joins a ``torch.distributed`` world, and a 2-D ``DeviceMesh`` names its two
axes as the JAX mesh does:

- "data"  — clips and index rows: the sharded search's shards, the
  trainer's batch shards;
- "model" — the (stream, split) ensemble: the sharded extractor runs each
  rank's share of every stream's splits (``pipeline/extract.py``); its
  size is 1 unless a caller asks.

The backend follows the device the caller names: NCCL for a CUDA device,
Gloo for the CPU (the tests). No call switches backend on failure. NCCL
refuses two ranks on one GPU, so a world on one card is one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from videoquery_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def initialize_multihost(init_method: str, world_size: int, rank: int,
                         device: torch.device | str | None = None) -> torch.device:
    """Join the world: ``torch.distributed.init_process_group`` with NCCL
    when ``device`` (``core.device.resolve_device``: cuda:0 unless "cpu" is
    named) is a CUDA device, which becomes the current one, and Gloo when it
    is the CPU. ``init_method`` is the rendezvous: ``tcp://host:port`` or
    ``file:///path`` (the tests use a file under their temporary
    directory). Returns the device."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return device


def make_mesh(device_type: str, model_parallel: int = 1):
    """A (data, model) ``DeviceMesh`` over the initialized world:
    world_size // model_parallel ranks along "data", model_parallel along
    "model"."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(f"{n} ranks not divisible by model_parallel={model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the current CUDA device on a "cuda"
    mesh (which raises without a card), else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_rank_and_size(mesh) -> tuple[int, int]:
    """This rank's coordinate along the mesh's "data" axis, and its size."""
    return mesh.get_local_rank(DATA_AXIS), mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def model_rank_and_size(mesh) -> tuple[int, int]:
    """This rank's coordinate along the mesh's "model" axis, and its size."""
    return mesh.get_local_rank(MODEL_AXIS), mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x (equal shapes) over ``group``, concatenated along
    ``dim`` in rank order, on every rank. The list form of
    ``dist.all_gather``: the one Gloo takes."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
