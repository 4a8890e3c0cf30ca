"""Sharded multi-query search: the 1M-segment serving path.

Port of ``videoquery/search/distributed.py``. The index's padded clip axis
is split into equal contiguous shards over the mesh's "data" axis, one a
rank (``FeatureIndex.shard``). Each rank scores the Q targets against its
shard and keeps its local top-k; only the [Q, k] values and global
positions of every shard cross the interconnect (``dist.all_gather`` over
the "data" group, NCCL between cards, Gloo on the CPU), never the [Q, N]
scores; every rank then takes the same final top-k over the world's R * k
candidates (``merge_topk``). The host sees only the final [Q, k].
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from videoquery_torch.core.meshes import DATA_AXIS, data_rank_and_size, mesh_device
from videoquery_torch.core.transfer import put_tree
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.kernels.query import fused_query_scores

IMPLS = ("pallas", "xla")


def _local_query(feats, mask, targets, tmask, weights, *, k):
    """Per-shard similarity + score + top-k in plain torch (the JAX
    package's ``_local_query``): targets rounded to the index dtype, f32
    products and sums, invalid clips -inf.

    feats  : [S, K, n, D] local shard      targets: f32[Q, S, K, D]
    mask   : bool[S, K, n]                 tmask  : bool[Q, S, K]
    weights: f32[Q, S]
    Returns (vals f32[Q, k], local_idx int64[Q, k]).
    """
    sims = torch.einsum("sknd,qskd->qskn", feats.float(),
                        targets.to(feats.dtype).float())
    m = mask[None] & tmask[:, :, :, None]                    # [Q, S, K, n]
    counts = m.sum(dim=2)                                    # [Q, S, n]
    total = torch.where(m, sims, 0.0).sum(dim=2)
    avg = total / counts.clamp(min=1)
    valid = (counts > 0).all(dim=1)                          # [Q, n]
    dev = weights[:, :, None] * (1.0 - avg)                  # [Q, S, n]
    num = (dev * dev).sum(dim=1)
    den = (weights * weights).sum(dim=1)[:, None]
    scores = torch.where(valid, 1.0 - torch.sqrt(num / den), -torch.inf)
    return torch.topk(scores, k)


def merge_topk(vals: torch.Tensor, positions: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The final top-k over R shards' candidates: vals f32[R, Q, k] and
    global positions int64[R, Q, k] (shard r's local top-k, its positions
    already offset by r * n_local) -> (vals f32[Q, k], positions int64[Q, k]).
    No collective: the caller gathers the shards' candidates first."""
    r, q, kk = vals.shape
    flat_vals = vals.permute(1, 0, 2).reshape(q, r * kk)
    flat_pos = positions.permute(1, 0, 2).reshape(q, r * kk)
    top_vals, sel = torch.topk(flat_vals, k)
    return top_vals, torch.gather(flat_pos, 1, sel)


class ShardedSearch:
    """Batched multi-query top-k over an index sharded along the mesh's
    "data" axis.

    impl="pallas" (the default) runs K1's scores epilogue on each shard
    (``kernels/query.py::fused_query_scores``; on the card the CUDA kernel,
    on the CPU its plain version), then ``torch.topk``. It differs on
    purpose from the JAX package's default, "xla": the port runs its
    kernel. impl="xla" is the plain per-shard einsum (``_local_query``),
    which runs only where a caller names it. K1 scores a clip missing a
    stream -1e30, the plain path -inf; either never outranks a valid clip.
    """

    def __init__(self, index: FeatureIndex, mesh, impl: str = "pallas"):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.mesh = mesh
        self.impl = impl
        self.rank, self.n_shards = data_rank_and_size(mesh)
        self.group = mesh.get_group(DATA_AXIS)
        # raises ValueError unless n_shards divides the padded clip axis
        self.index = index.shard(self.rank, self.n_shards, mesh_device(mesh))
        self.n_clips = index.n_clips

    @property
    def device(self) -> torch.device:
        return self.index.device

    def pack_targets(
        self,
        targets: Sequence[Mapping[str, Mapping[int, Sequence[float]]]],
        weights: Sequence[Mapping[str, float]],
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[{stream: {split: vec}}] -> (targets f32[Q, S, K, D], tmask
        bool[Q, S, K], weights f32[Q, S]) on this rank's device, packed on
        the host and copied up once per dtype."""
        q = len(targets)
        idx = self.index
        t = np.zeros((q, len(idx.streams), len(idx.splits), idx.feature_dim), np.float32)
        m = np.zeros((q, len(idx.streams), len(idx.splits)), bool)
        w = np.zeros((q, len(idx.streams)), np.float32)
        for qi, (target, wt) in enumerate(zip(targets, weights)):
            t[qi], m[qi] = idx.target_arrays_host(target, np.float32)
            w[qi] = [wt[s] for s in idx.streams]
        return put_tree((t, m, w), self.device)

    def _shard_topk(self, targets, tmask, weights, k: int):
        idx = self.index
        if self.impl == "pallas":
            scores = fused_query_scores(idx.feats, idx.mask, targets, tmask, weights)
            return torch.topk(scores, k)
        return _local_query(idx.feats, idx.mask, targets, tmask, weights, k=k)

    def topk(self, targets, tmask, weights, k: int = 20
             ) -> tuple[np.ndarray, np.ndarray]:
        """Device tensors in, (scores f32[Q, k], clip_ids int64[Q, k]) out on
        the host, equal on every rank: the shard's top-k, one all-gather of
        the [Q, k] values and global positions over the "data" group, then
        ``merge_topk``. ids are -1 at positions beyond n_clips (padding)."""
        vals, idx = self._shard_topk(targets, tmask, weights, k)
        pos = idx + self.rank * self.index.n_padded
        all_vals = [torch.empty_like(vals) for _ in range(self.n_shards)]
        all_pos = [torch.empty_like(pos) for _ in range(self.n_shards)]
        dist.all_gather(all_vals, vals.contiguous(), group=self.group)
        dist.all_gather(all_pos, pos.contiguous(), group=self.group)
        vals, pos = merge_topk(torch.stack(all_vals), torch.stack(all_pos), k)
        vals, pos = vals.cpu().numpy(), pos.cpu().numpy()
        ids = np.where(pos < self.n_clips,
                       self.index.clip_ids[np.minimum(pos, self.n_clips - 1)], -1)
        return vals, ids

    def query_dicts(self, target_dicts, weight_dicts, k: int = 20):
        t, m, w = self.pack_targets(target_dicts, weight_dicts)
        return self.topk(t, m, w, k)
