"""Batched host->device transfers.

Port of ``videoquery/core/transfer.py``. ``put_tree`` uploads a nested
dict / list / tuple of arrays with one copy per dtype instead of one per
leaf: the leaves of a dtype are packed into one flat (on a CUDA device,
pinned) host buffer, copied once without a host wait, and carved back
out on the device as views. ``device_constant`` keeps the small host-built
arrays of the extraction path (resize and crop matrices, means) on the
device, uploaded once in the same way. ``local_rows`` is the multi-process
ingest contract of the JAX ``put_global``: every rank is given the SAME
global host array and keeps its own contiguous rows.
"""

from __future__ import annotations

from typing import Callable, Hashable

import numpy as np
import torch
from torch.utils import _pytree as pytree


def put_tree(tree, device: torch.device | str):
    """Copy a pytree of numpy arrays / scalars / tensors to `device` with one
    host-to-device copy per dtype. Leaves keep their dtype and shape (numpy
    float64 stays float64); each comes back as a view into its dtype's
    buffer on the device.

    On a CUDA device the leaves are packed into a pinned buffer before this
    returns (the caller may reuse its arrays at once) and the copy is queued
    with ``non_blocking``: the host does not wait for the card. torch's
    caching host allocator records the copy on the buffer, so the buffer is
    not handed out again before the copy has ended."""
    device = torch.device(device)
    leaves, spec = pytree.tree_flatten(tree)
    if not leaves:
        return tree
    host = [torch.from_numpy(np.require(leaf, requirements=["C"]))
            if not isinstance(leaf, torch.Tensor) else leaf.detach().cpu()
            for leaf in leaves]
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(host):
        by_dtype.setdefault(t.dtype, []).append(i)
    out: list = [None] * len(host)
    for dtype, idxs in by_dtype.items():
        total = sum(host[i].numel() for i in idxs)
        flat = torch.empty(total, dtype=dtype, pin_memory=device.type == "cuda")
        o = 0
        for i in idxs:
            n = host[i].numel()
            flat[o:o + n] = host[i].reshape(-1)
            o += n
        buf = flat.to(device, non_blocking=True)
        o = 0
        for i in idxs:
            n = host[i].numel()
            out[i] = buf[o:o + n].view(host[i].shape)
            o += n
    return pytree.tree_unflatten(out, spec)


_CONSTANTS: dict[tuple, torch.Tensor] = {}


def device_constant(key: Hashable, make: Callable[[], np.ndarray],
                    device: torch.device | str) -> torch.Tensor:
    """The host array ``make()`` as a tensor on `device`. On a CUDA device
    it is made and uploaded once per (key, device, current stream) and kept:
    the upload is a non-blocking copy from pinned memory queued on that
    stream, so every later use on the stream follows it and the host never
    waits. Callers must not write to the result. On the CPU it is
    ``torch.from_numpy(make())``."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(make())
    stream = torch.cuda.current_stream(device)
    k = (key, device, stream.stream_id)
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = put_tree(np.asarray(make()), device)
    return t


def local_rows(x, rank: int, world: int, dim: int = 0):
    """This rank's contiguous share of dimension `dim` of the global array
    `x` (numpy or tensor; a view). Every rank passes equal data, as the JAX
    callers of put_global do. Raises ValueError unless `world` divides the
    dimension."""
    n = x.shape[dim]
    if n % world != 0:
        raise ValueError(f"dimension {dim} of size {n} not divisible by {world} ranks")
    step = n // world
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, rank * step, step)
    index = [slice(None)] * x.ndim
    index[dim] = slice(rank * step, (rank + 1) * step)
    return x[tuple(index)]

