"""Process groups and device meshes for the port's scale-out path.

Port of ``videoquery/core/meshes.py``. The JAX package runs one SPMD
program over a ``jax.sharding.Mesh``; here each process owns one device and
joins a ``torch.distributed`` world, and a 2-D ``DeviceMesh`` names its two
axes as the JAX mesh does:

- "data"  — clips and index rows: the sharded search's shards, the
  trainer's batch shards;
- "model" — the (stream, split) ensemble or a larger backbone; nothing in
  the port splits over it yet, so its size is 1 unless a caller asks.

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


def data_rank_and_size(mesh) -> tuple[int, int]:
    """This rank's coordinate along the mesh's "data" axis, and its size."""
    return mesh.get_local_rank(DATA_AXIS), mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
