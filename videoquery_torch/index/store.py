"""Dense embedding index on one device.

The search set is held as

    feats  [S, K, Npad, D]  float32 or bfloat16
    mask   [S, K, Npad]     bool
    clip_ids int64[N]       ascending, real clips only (host numpy)

with the clip axis padded to a multiple with mask=False rows that never
match. The tensors are assembled on the host and copied to the device once
per index.
"""

from __future__ import annotations

from typing import Iterable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from videoquery_torch.core.meshes import pad_to_multiple
from videoquery_torch.index.records import FeatureRecord

_DTYPES = (torch.float32, torch.bfloat16)


class ShardSpec(NamedTuple):
    """What a shard of an index is: ``rank``'s contiguous share of
    ``n_local`` positions of the padded clip axis, of ``world`` shares."""
    rank: int
    world: int
    n_local: int

    def locate(self, positions) -> tuple[np.ndarray, np.ndarray]:
        """Global positions -> (owner rank, position within the owner's
        shard), int64 arrays of the positions' shape."""
        return np.divmod(np.asarray(positions, np.int64), self.n_local)

    def local(self, positions) -> tuple[np.ndarray, np.ndarray]:
        """Global positions -> (position on THIS shard, 0 where another rank
        owns it; owner rank)."""
        owner, local = self.locate(positions)
        return np.where(owner == self.rank, local, 0), owner


class FeatureIndex:
    """Dense (stream, split, clip) -> embedding index.

    Canonical clip order is ascending clip id. `n_clips` is the real clip
    count; the tensors are padded to `pad_multiple` with mask=False rows.
    """

    def __init__(
        self,
        clip_ids: np.ndarray,      # i64[N] ascending, real clips only
        feats: torch.Tensor,       # [S, K, Npad, D] float32 | bfloat16
        mask: torch.Tensor,        # bool[S, K, Npad]
        streams: tuple[str, ...],
        splits: tuple[int, ...],
        feature_name: str,
    ):
        if feats.dtype not in _DTYPES:
            raise ValueError(f"index dtype must be float32 or bfloat16, got {feats.dtype}")
        if mask.dtype != torch.bool or tuple(mask.shape) != tuple(feats.shape[:3]):
            raise ValueError("mask must be bool [S, K, Npad] matching feats")
        self.clip_ids = clip_ids
        self.feats = feats
        self.mask = mask
        self.streams = streams
        self.splits = splits
        self.feature_name = feature_name
        self._id_to_pos = {int(c): i for i, c in enumerate(clip_ids)}
        # host float64 copies for the exact (reference-parity) similarity
        # path; set by build(keep_host=True)
        self.host_feats: np.ndarray | None = None
        self.host_mask: np.ndarray | None = None
        # set by shard(): None for a whole index
        self.shard_spec: ShardSpec | None = None

    # -- construction -------------------------------------------------------

    @staticmethod
    def build(
        records: Iterable[FeatureRecord],
        streams: Sequence[str],
        splits: Sequence[int] | None = None,
        feature_name: str = "global_pool",
        feature_dim: int | None = None,
        pad_multiple: int = 8,
        *,
        device: torch.device | str,
        dtype: torch.dtype = torch.float32,
        keep_host: bool = False,
    ) -> "FeatureIndex":
        recs = [
            r for r in records
            if r.stream in streams and r.name == feature_name
            and (splits is None or r.split in splits)
        ]
        if not recs:
            raise ValueError("no matching feature records")
        if splits is None:
            splits = sorted({r.split for r in recs})
        splits = tuple(int(s) for s in splits)
        streams = tuple(streams)
        clip_ids = np.asarray(sorted({r.clip_id for r in recs}), np.int64)
        dim = feature_dim or len(recs[0].vector)
        n_pad = pad_to_multiple(max(len(clip_ids), 1), pad_multiple)
        feats = np.zeros((len(streams), len(splits), n_pad, dim), np.float64)
        mask = np.zeros((len(streams), len(splits), n_pad), bool)
        pos = {int(c): i for i, c in enumerate(clip_ids)}
        s_idx = {s: i for i, s in enumerate(streams)}
        k_idx = {k: i for i, k in enumerate(splits)}
        for r in recs:
            v = np.asarray(r.vector, np.float64)
            if v.shape[0] != dim:
                raise ValueError(
                    f"feature for clip {r.clip_id} has dim {v.shape[0]}, expected {dim}"
                )
            feats[s_idx[r.stream], k_idx[r.split], pos[r.clip_id]] = v
            mask[s_idx[r.stream], k_idx[r.split], pos[r.clip_id]] = True
        # cast once from the f64 staging buffer (via f32, as the reference
        # rounds), then ONE host->device copy per tensor
        feats_t = torch.from_numpy(feats.astype(np.float32)).to(dtype)
        index = FeatureIndex(clip_ids, feats_t.to(device),
                             torch.from_numpy(mask).to(device),
                             streams, splits, feature_name)
        if keep_host:
            index.host_feats = feats
            index.host_mask = mask
        return index

    @staticmethod
    def from_feature_dicts(
        per_clip: Mapping[int, Mapping[str, Mapping[int, Sequence[float]]]],
        streams: Sequence[str],
        feature_name: str = "global_pool",
        **kwargs,
    ) -> "FeatureIndex":
        """Build from {clip_id: {stream: {split: vector}}} (the shape the
        service layer assembles from API responses); ``kwargs`` go to
        ``build`` (``device`` among them)."""
        records = [
            FeatureRecord(cid, stream, split, feature_name, np.asarray(vec))
            for cid, sd in per_clip.items()
            for stream, kd in sd.items()
            for split, vec in kd.items()
        ]
        return FeatureIndex.build(records, streams, feature_name=feature_name, **kwargs)

    @staticmethod
    def from_numpy(
        clip_ids: np.ndarray,
        feats: np.ndarray,
        mask: np.ndarray,
        streams: Sequence[str],
        splits: Sequence[int],
        feature_name: str,
        *,
        device: torch.device | str,
        dtype: torch.dtype = torch.float32,
    ) -> "FeatureIndex":
        """The port's index over arrays that already exist, e.g. a JAX
        FeatureIndex's (clip_ids, feats, mask) passed as numpy, so both
        packages score identical data. feats may be float32, float64 or a
        bfloat16 numpy array (ml_dtypes); it is converted to `dtype`."""
        # contiguous and writable (a JAX array's numpy view is read-only)
        feats = np.require(feats, requirements=["C", "W"])
        if feats.dtype.name == "bfloat16":
            feats_t = torch.from_numpy(feats.view(np.uint16)).view(torch.bfloat16)
        else:
            feats_t = torch.from_numpy(feats)
        if feats_t.dtype == torch.float64:
            feats_t = feats_t.float()  # round once via f32, as build does
        return FeatureIndex(
            np.asarray(clip_ids, np.int64),
            feats_t.to(dtype).to(device),
            torch.from_numpy(np.require(mask, bool, ["C", "W"])).to(device),
            tuple(streams), tuple(int(k) for k in splits), feature_name,
        )

    # -- queries -------------------------------------------------------------

    @property
    def n_clips(self) -> int:
        return len(self.clip_ids)

    @property
    def n_padded(self) -> int:
        return self.feats.shape[2]

    @property
    def feature_dim(self) -> int:
        return self.feats.shape[3]

    @property
    def device(self) -> torch.device:
        return self.feats.device

    def position(self, clip_id: int) -> int | None:
        """The clip's GLOBAL position on the padded clip axis (a shard's
        too), or None."""
        return self._id_to_pos.get(int(clip_id))

    def target_arrays(
        self, target: Mapping[str, Mapping[int, Sequence[float]]]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Pack a {stream: {split: vector}} target dict into (targets
        f32[S, K, D], target_mask bool[S, K]) on the index's device, each
        vector rounded to float32 once, as the JAX package's
        ``target_arrays`` does."""
        t, m = self.target_arrays_host(target, np.float32)
        return torch.from_numpy(t).to(self.device), torch.from_numpy(m).to(self.device)

    def target_arrays_host(
        self, target: Mapping[str, Mapping[int, Sequence[float]]], dtype=np.float64,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Pack a {stream: {split: vector}} target dict into host arrays
        (targets [S, K, D] of `dtype`, float64 unless named;
        target_mask bool[S, K])."""
        t = np.zeros((len(self.streams), len(self.splits), self.feature_dim), dtype)
        m = np.zeros((len(self.streams), len(self.splits)), bool)
        for si, stream in enumerate(self.streams):
            for ki, split in enumerate(self.splits):
                vec = target.get(stream, {}).get(split)
                if vec is None:  # JSON round-trips may stringify split keys
                    vec = target.get(stream, {}).get(str(split))
                if vec is not None:
                    t[si, ki] = np.asarray(vec, dtype)
                    m[si, ki] = True
        return t, m

    def shard(self, rank: int, world: int, device: torch.device | str) -> "FeatureIndex":
        """Rank `rank`'s contiguous share of the padded clip axis, of `world`
        equal shares, on `device` (a view when it is already there and
        contiguous, else one copy). The shard keeps the GLOBAL clip_ids on
        the host, so its ``n_clips`` and ``position`` are the whole index's
        while its ``n_padded`` is the shard's length; ``shard_spec`` records
        (rank, world, n_local), and its position p is global position
        ``rank * n_local + p`` (``shard_spec.locate`` maps back). Raises ValueError
        unless `world` divides the padded clip axis (build the index with a
        pad_multiple that is a multiple of the world size), or when this
        index is itself a shard."""
        if self.shard_spec is not None:
            raise ValueError(f"this index is already shard {self.shard_spec}; "
                             "shard the whole index")
        if self.n_padded % world != 0:
            raise ValueError(
                f"padded clip axis {self.n_padded} not divisible by {world} data "
                f"shards; build the index with pad_multiple={world} (or a multiple)")
        n_local = self.n_padded // world
        rows = slice(rank * n_local, (rank + 1) * n_local)
        out = FeatureIndex(self.clip_ids,
                           self.feats[:, :, rows].to(device).contiguous(),
                           self.mask[:, :, rows].to(device).contiguous(),
                           self.streams, self.splits, self.feature_name)
        out.shard_spec = ShardSpec(rank, world, n_local)
        return out
