"""The corpus cells' world: clips on cones around many axes, made on the card.

A copy of ``videoquery_torch/testing/sharded_serving.py::cone_world``,
widened from one axis to ``n_clusters``: each clip belongs to one cluster
(a scene or subject that many segments show) and lies at an angle
``theta`` off the cluster's axis, the angles of a cluster spread evenly
from 0 to ``angle_max`` and dealt in a seeded order. Each member (stream,
split) of a clip is ``cos(t) a + sin(t) w``, with ``t`` the clip's angle
plus N(0, ``member_sigma``^2) and ``w`` a random unit vector normal to the
axis ``a``. As in ``cone_world``, one clip in 7 misses its second flow
split and one in 23 its whole rgb stream (never scored); clip ids are
``10 p + 3`` at position p.

With one axis the clips of a fitted round's band would be a fixed share of
the whole corpus; with a cluster of ~3,900 clips the band of a round holds
~2,000. A target is a cone vector at ``offset`` off its cluster's axis,
one vector a (stream, split), as ``cone_world``'s query q is at
0.05 (q + 1); the target of the third query slot of each group lacks its
third split.

The features are drawn on the card by a ``torch.Generator`` of the seed,
a block of rows at a time; the axes, the clusters, the angles and the
targets by numpy's generator of the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

STREAMS = ("rgb", "warped_optical_flow")
SPLITS = (1, 2, 3)
BLOCK_ROWS = 1 << 17


@dataclasses.dataclass
class World:
    clip_ids: np.ndarray     # i64[N] ascending
    feats: object            # torch [S, K, Npad, D] in the configured dtype
    mask: object             # torch bool [S, K, Npad]
    axes: np.ndarray         # f64[C, D] unit axes
    cluster: np.ndarray      # i32[N] the cluster of each position
    theta: np.ndarray        # f64[N] the angle of each position off its axis
    valid: np.ndarray        # bool[N] every stream present (the clip is scored)
    rng: np.random.Generator  # numpy's generator, for the traffic drawn after

    @property
    def n_clips(self) -> int:
        return len(self.clip_ids)


def host_mask(n_pad: int, n_clips: int) -> np.ndarray:
    """bool[S, K, Npad]: ``cone_world``'s missing members."""
    pos = np.arange(n_pad)
    mask = np.broadcast_to(pos < n_clips, (len(STREAMS), len(SPLITS), n_pad)).copy()
    mask[1, 1] &= pos % 7 != 3
    mask[0] &= (pos % 23 != 5)[None]
    return mask


def make_world(n_clips: int, dim: int, n_clusters: int, angle_max: float,
               member_sigma: float, seed: int, device, dtype: str,
               pad_multiple: int) -> World:
    import torch

    rng = np.random.default_rng(seed)
    axes = rng.standard_normal((n_clusters, dim))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    cluster = (np.arange(n_clips) % n_clusters)[rng.permutation(n_clips)].astype(np.int32)
    theta = np.empty(n_clips)
    for c in range(n_clusters):
        members = np.flatnonzero(cluster == c)
        theta[members] = np.linspace(0.0, angle_max, len(members))[
            rng.permutation(len(members))]
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    n_pad = -(-n_clips // pad_multiple) * pad_multiple
    feats = torch.zeros((len(STREAMS), len(SPLITS), n_pad, dim),
                        dtype=getattr(torch, dtype), device=device)
    axes_t = torch.tensor(axes, dtype=torch.float32, device=device)
    cluster_t = torch.from_numpy(cluster).to(device).long()
    theta_t = torch.tensor(theta, dtype=torch.float32, device=device)
    for si in range(len(STREAMS)):
        for ki in range(len(SPLITS)):
            for a in range(0, n_clips, BLOCK_ROWS):
                b = min(n_clips, a + BLOCK_ROWS)
                t = theta_t[a:b] + member_sigma * torch.randn(
                    b - a, generator=g, device=device)
                u = axes_t[cluster_t[a:b]]
                w = torch.randn((b - a, dim), generator=g, device=device)
                w -= (w * u).sum(dim=1, keepdim=True) * u
                w /= w.norm(dim=1, keepdim=True)
                w *= torch.sin(t)[:, None]
                w += torch.cos(t)[:, None] * u
                feats[si, ki, a:b] = w.to(feats.dtype)
                del u, w
    mask_h = host_mask(n_pad, n_clips)
    mask = torch.from_numpy(mask_h).to(device)
    valid = mask_h[:, :, :n_clips].any(axis=1).all(axis=0)
    return World(10 * np.arange(n_clips, dtype=np.int64) + 3, feats, mask, axes,
                 cluster, theta, valid, rng)


def cone_target(rng: np.random.Generator, axis: np.ndarray, offset: float,
                splits=SPLITS) -> dict:
    """A target dict {stream: {split: list}} whose members lie ``offset``
    off ``axis``, each along its own random direction normal to it."""
    def cone():
        w = rng.standard_normal(axis.shape[0])
        w -= w @ axis * axis
        w /= np.linalg.norm(w)
        return (np.cos(offset) * axis + np.sin(offset) * w).tolist()

    return {s: {k: cone() for k in splits} for s in STREAMS}


def slot_target(world: World, rng: np.random.Generator, slot: int,
                offsets) -> tuple[dict, int]:
    """The target of a query in group slot ``slot``: a cluster drawn by the
    seed, at the slot's offset; slot 2 lacks split 3. Returns (target,
    cluster)."""
    c = int(rng.integers(len(world.axes)))
    splits = SPLITS[:2] if slot % len(offsets) == 2 else SPLITS
    return cone_target(rng, world.axes[c], offsets[slot % len(offsets)], splits), c
