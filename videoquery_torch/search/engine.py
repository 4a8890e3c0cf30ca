"""SearchEngine: the device-side query round.

Glues the FeatureIndex to the scoring/optimizer math. The similarity pass of
a whole poll group is one K1 launch (scoring.ensemble_similarities_batched);
the optimizer grid runs on the host in float64.

Two round flavors:

- SimilarityTable (compute_similarities): downloads the whole [S, N]
  similarity table and counts once and finishes the round host-side in
  float64 — the default for broker-scale search sets.
- ResidentTable (compute_similarities_resident): the big-corpus path. The
  table stays on the device; the optimizer gathers only the reviewed rows
  and selection downloads only the BANDED candidates (matches + near-misses
  + kept clips). Selection results are IDENTICAL to the full path: the
  device band is widened by a margin exceeding any f32-vs-f64 score
  discrepancy and select_clips_to_review re-applies the exact float64 band.

With a mesh (``SearchEngine(index, mesh=mesh)``) the index is split over
the mesh's "data" axis (``FeatureIndex.shard``) and each rank runs K1 on
its own shard. Every rank then holds the unsharded engine's results, bit
for bit where K1's per-clip sums do not depend on the shard's length (on
the card): a table is all-gathered; a reviewed or kept clip is read on the
rank that owns it and assembled by all-gather and selection (a sum of
zeros would lose -0.0); finalize's lowest user match is an all-reduce MIN;
each rank's banded candidates are all-gathered and merged in rank order
(``merge_banded``), so the cap counts the whole band on every rank.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from videoquery_torch.core.config import HyperParams, compute_eps
from videoquery_torch.core.meshes import (DATA_AXIS, all_gather_cat,
                                          data_rank_and_size, mesh_device)
from videoquery_torch.index.store import FeatureIndex, ShardSpec
from videoquery_torch.search.optimizer import GridResult, optimize_weights
from videoquery_torch.search.scoring import (ensemble_similarities_batched,
                                             scores_from_similarities)

# Device-band widening for the big-corpus candidate download. The device
# evaluates scores and the near-miss bound in f32 while selection re-applies
# them in f64; both discrepancies are bounded by a few f32 ulps of values
# <= 1 (~1e-6 after the finalize bound's arithmetic), so a 1e-5 margin
# guarantees the downloaded candidate set is a superset of the exact band.
_BAND_MARGIN = 1e-5

_CAPS = (32_768, 262_144)


def _banded_core(avg, counts, weights, threshold, near_miss, eps,
                 keep_pos, low, cap: int):
    """Everything selection needs, for B queries at once, as one f32 tensor
    [B, L] (one download).

    avg f32[B, S, N], counts i32[B, S, N], weights f32[B, S], threshold and
    near_miss f32[B], eps a float, keep_pos i64[B, KP], low None or f32[B].

    Row layout: candidates [S+2, cap] (avg rows, valid bit, position as an
    exact-in-f32 integer, -1 past the band), kept clips [S+1, KP] (avg rows,
    valid bit), then [n_in_band]. The in-band positions are scattered by
    rank into a [cap] row padded with -1 (ascending positions). finalize
    passes ``low``, the lowest user-match score (``_local_low``), and the
    near-miss bound derives from it on device (reference
    compute_matches.py:78-85 arithmetic in f32; the margin absorbs the f64
    difference); otherwise it is ``near_miss``.

    Every op is elementwise or a reduction within one row, so a row's bits
    are the same whatever B is: the solo and group paths agree."""
    b, s, n = avg.shape
    valid = (counts > 0).all(dim=1)                                 # [B, N]
    scores = torch.where(valid, scores_from_similarities(avg, weights),
                         torch.tensor(-torch.inf, device=avg.device))
    if low is not None:
        low = torch.clamp(low, max=1.0)
        nm = (torch.clamp(threshold - low, min=0.0)
              / torch.clamp(1.0 - threshold, min=eps))
    else:
        nm = near_miss
    lower = threshold - nm * (1.0 - threshold)                       # [B]
    in_band = scores >= (lower - _BAND_MARGIN)[:, None]
    n_cand = in_band.sum(dim=1)                                      # [B]
    rank = torch.cumsum(in_band, dim=1) - 1
    slot = torch.where(in_band & (rank < cap), rank,
                       torch.tensor(cap, device=avg.device))         # cap = drop
    idx = torch.full((b, cap + 1), -1, dtype=torch.int64, device=avg.device)
    idx.scatter_(1, slot, torch.arange(n, device=avg.device).expand(b, n))
    idx = idx[:, :cap]                                               # [B, cap]
    safe = idx.clamp(min=0)
    cand = torch.cat([
        torch.gather(avg, 2, safe[:, None].expand(b, s, cap)),
        (torch.gather(valid, 1, safe) & (idx >= 0)).float()[:, None],
        idx.float()[:, None],  # exact: cap < 2^24
    ], dim=1)
    kp = keep_pos.shape[1]
    keep = torch.cat([
        torch.gather(avg, 2, keep_pos[:, None].expand(b, s, kp)),
        torch.gather(valid, 1, keep_pos).float()[:, None],
    ], dim=1)
    return torch.cat([cand.reshape(b, -1), keep.reshape(b, -1),
                      n_cand.float()[:, None]], dim=1)


def _local_low(avg, counts, weights, um_pos: np.ndarray, um_mask: np.ndarray,
               spec: ShardSpec | None):
    """f32[B]: the lowest score among the valid user matches of each row
    that this shard owns (all of them when spec is None), +inf where there
    is none. The score is elementwise in the clip, so scoring the gathered
    user matches gives the bits of scoring every clip and gathering."""
    dev = avg.device
    if spec is not None:
        um_pos, owner = spec.local(um_pos)
        um_mask = um_mask & (owner == spec.rank)
    b, s, _ = avg.shape
    idx = torch.from_numpy(um_pos).to(dev)[:, None].expand(b, s, -1)
    ok = (torch.from_numpy(um_mask).to(dev)
          & (torch.gather(counts, 2, idx) > 0).all(dim=1))
    um_scores = scores_from_similarities(torch.gather(avg, 2, idx), weights)
    return torch.where(ok, um_scores,
                       torch.tensor(torch.inf, device=dev)).amin(dim=1)


def _local_rows(avg, counts, weights, threshold, near_miss, keep_pos: np.ndarray,
                low, cap: int, spec: ShardSpec | None):
    """This shard's packed rows (``_banded_core``) over its own positions:
    a kept clip that another rank owns reads position 0 here, and the merge
    takes that slot from its owner."""
    if spec is not None:
        keep_pos = spec.local(keep_pos)[0]
    return _banded_core(avg, counts, weights, threshold, near_miss, compute_eps(),
                        torch.from_numpy(keep_pos).to(avg.device), low, cap)


def merge_banded(rows: np.ndarray, n_streams: int, cap: int, n_local: int,
                 keep_owner: np.ndarray) -> np.ndarray:
    """One packed row (``_banded_core``'s layout) of the whole index from the
    R shards' rows of one query, f64[R, L] in rank order, no collective.

    A shard's in-band positions fill the first min(n_in_band, cap) slots of
    its row, ascending; offset by ``rank * n_local`` and concatenated in
    rank order they stay ascending, and the first ``cap`` of them are the
    unsharded row's. The kept slot j comes from rank ``keep_owner[j]``;
    ``n_in_band`` is the sum, so a band wider than ``cap`` overflows the
    merged row even when no shard's does. Slots past the band carry
    position -1 and are never read."""
    s = n_streams
    cand_sz = (s + 2) * cap
    kp = keep_owner.shape[0]
    out = np.zeros(rows.shape[1])
    cand = out[:cand_sz].reshape(s + 2, cap)
    cand[s + 1] = -1.0
    m = 0
    for r, row in enumerate(rows):
        n = min(int(row[-1]), cap - m)          # this shard's live prefix
        cand[:, m:m + n] = row[:cand_sz].reshape(s + 2, cap)[:, :n]
        cand[s + 1, m:m + n] += r * n_local
        m += n
    keep = rows[:, cand_sz:cand_sz + (s + 1) * kp].reshape(len(rows), s + 1, kp)
    out[cand_sz:-1] = keep[keep_owner, :, np.arange(kp)].T.ravel()    # [S+1, KP]
    out[-1] = rows[:, -1].sum()
    return out


def select_owned(stacked: np.ndarray, owner: np.ndarray) -> np.ndarray:
    """Every rank's gather of the same positions, stacked [R, B, S, M] in
    rank order, -> [B, S, M] with each position's values from the rank that
    owns it (owner int[B, M]): a selection, so the bits move unchanged."""
    _, b, s, m = stacked.shape
    return stacked[owner[:, None, :], np.arange(b)[:, None, None],
                   np.arange(s)[None, :, None], np.arange(m)[None, None, :]]


def _band_rows(index: FeatureIndex, group, avg, counts, w: np.ndarray,
               threshold, near_miss, keep_pos: np.ndarray, um_pos: np.ndarray,
               um_mask: np.ndarray, finalize: bool, cap: int) -> Sequence[np.ndarray]:
    """The packed rows (f64[L] each, global positions) of B queries over the
    engine's index; on a shard, the rows of the whole index on every rank:
    the user matches' minimum all-reduced, the shards' rows all-gathered
    over ``group`` and merged (``merge_banded``), one array a query."""
    dev = avg.device
    spec = index.shard_spec
    wt = torch.tensor(w, dtype=torch.float32, device=dev)
    low = None
    if finalize:
        low = _local_low(avg, counts, wt, um_pos, um_mask, spec)
        if spec is not None:
            dist.all_reduce(low, op=dist.ReduceOp.MIN, group=group)
    rows = _local_rows(
        avg, counts, wt,
        torch.tensor(threshold, dtype=torch.float32, device=dev),
        torch.tensor(near_miss, dtype=torch.float32, device=dev),
        keep_pos, low, cap, spec)
    if spec is None:
        return rows.cpu().numpy().astype(np.float64)
    stacked = all_gather_cat(rows[None], group).cpu().numpy().astype(np.float64)
    owners = spec.locate(keep_pos)[0]
    return [merge_banded(stacked[:, i], len(index.streams), cap, spec.n_local, owners[i])
            for i in range(stacked.shape[1])]


def _reviewed_rows(index: FeatureIndex, group, rows, pos: np.ndarray) -> np.ndarray:
    """f32[B, S, M] of rows [B, S, N] (on the device) at the global positions
    pos int[B, M], on the host; on a shard, each gathered on the rank that
    owns it, then all-gathered over ``group`` and selected."""
    spec = index.shard_spec
    local = pos if spec is None else spec.local(pos)[0]
    idx = torch.from_numpy(local).to(rows.device)[:, None].expand(-1, rows.shape[1], -1)
    got = torch.gather(rows, 2, idx)
    if spec is None:
        return got.cpu().numpy()
    return select_owned(all_gather_cat(got[None], group).cpu().numpy(),
                        spec.locate(pos)[0])


def _scores_f64(avg: np.ndarray, w: np.ndarray) -> np.ndarray:
    """float64 weighted score of f32 similarity rows — the same bits
    SimilarityTable.scores produces (ticket.py:165-180)."""
    dev = w[:, None] * (1.0 - avg.astype(np.float64))
    return 1.0 - np.sqrt((dev * dev).sum(axis=0) / (w * w).sum())


def _pad_positions(pos: list[int], multiple: int = 8, at_least: int = 0
                   ) -> tuple[np.ndarray, int]:
    """Pad a position list (position 0 as filler, never read back) to a
    multiple of 8, at least `at_least` so a poll group shares one shape."""
    m = len(pos)
    mp = max(multiple, at_least, -(-m // multiple) * multiple)
    out = np.zeros(mp, np.int64)
    out[:m] = pos
    return out, m


class SimilarityTable:
    """Host-side view of the device similarity computation for one target."""

    def __init__(self, index: FeatureIndex, avg_sim: np.ndarray, counts: np.ndarray):
        self.index = index
        self.avg_sim = avg_sim  # f32[S, Npad] (f64 in exact mode)
        self.counts = counts    # i32[S, Npad]

    def valid_positions(self) -> np.ndarray:
        """Index positions of the clips with every stream present."""
        n = self.index.n_clips
        return np.flatnonzero((self.counts[:, :n] > 0).all(axis=0))

    def similarities_dict(self) -> dict[int, dict[str, list]]:
        """The reference's similarity structure
        {clip: {stream: [avg_sim, n_ensemble]}} (ticket.py:124), in
        ascending clip-id order."""
        out: dict[int, dict[str, list]] = {}
        for pos in range(self.index.n_clips):
            entry = {}
            for si, stream in enumerate(self.index.streams):
                c = int(self.counts[si, pos])
                if c > 0:
                    entry[stream] = [float(self.avg_sim[si, pos]), c]
            if entry:
                out[int(self.index.clip_ids[pos])] = entry
        return out

    def scores(self, weights: Mapping[str, float]) -> dict[int, float]:
        """{clip_id: score} for every clip with all streams present, ascending
        clip id (ticket.py:165-180 + the determinism contract), computed on
        the host in float64."""
        n = self.index.n_clips
        w = np.asarray([weights[s] for s in self.index.streams], np.float64)
        avg = self.avg_sim[:, :n].astype(np.float64)
        valid = (self.counts[:, :n] > 0).all(axis=0)
        dev = w[:, None] * (1.0 - avg)
        sc = 1.0 - np.sqrt((dev * dev).sum(axis=0) / (w * w).sum())
        ids = np.asarray(self.index.clip_ids[:n])[valid]
        return dict(zip(ids.tolist(), sc[valid].tolist()))

    def optimize(
        self, reviewed_labels: Mapping[int, float], hp: HyperParams
    ) -> tuple[HyperParams, GridResult]:
        """Grid + parabolic optimization over the reviewed clips
        (hyperparameter.py:29-76). reviewed_labels: {clip_id: 0/1}."""
        positions, labels = _reviewed_positions(self.index, reviewed_labels)
        sim = self.avg_sim[:, np.asarray(positions, np.int64)]
        return _round_state(hp, sim, labels)


def _reviewed_positions(index: FeatureIndex, reviewed_labels
                        ) -> tuple[list[int], list[float]]:
    positions, labels = [], []
    for clip_id, label in reviewed_labels.items():
        pos = index.position(clip_id)
        if pos is None:
            raise KeyError(f"reviewed clip {clip_id} not in the search set")
        positions.append(pos)
        labels.append(float(label))
    return positions, labels


def pack_targets(index: FeatureIndex, targets: Sequence[Mapping]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Q target dicts -> (f32[Q, S, K, D], bool[Q, S, K]) on the index's
    device, each vector rounded from float64 to float32 once."""
    s, k, d = len(index.streams), len(index.splits), index.feature_dim
    t = np.zeros((len(targets), s, k, d), np.float32)
    m = np.zeros((len(targets), s, k), bool)
    for qi, target in enumerate(targets):
        ta, ma = index.target_arrays_host(target)
        t[qi], m[qi] = ta.astype(np.float32), ma
    return torch.from_numpy(t).to(index.device), torch.from_numpy(m).to(index.device)


def _round_state(hp: HyperParams, sim: np.ndarray, labels: list[float]
                 ) -> tuple[HyperParams, GridResult]:
    result = optimize_weights(
        sim, np.asarray(labels, np.float64),
        hp.weight_grid, hp.threshold_grid, hp.ballast, compute_eps(),
    )
    new_weights = {hp.streams[0]: 1.0, hp.streams[1]: result.weight}
    return hp.with_round_state(new_weights, result.threshold), result


class ResidentTable:
    """Device-resident similarity table: the big-corpus round.

    avg/counts stay on the device. optimize() downloads only the reviewed
    rows ([S, M] for M reviewed clips); round_scores() downloads only the
    banded candidates plus kept clips, returning the reduced ascending-clip-id
    scores dict that select_clips_to_review needs — its exact float64 band
    filtering makes the selection identical to the full-download path.

    On a shard of the index (a sharded SearchEngine), avg/counts are the
    shard's and every method is a collective over ``group``, the mesh's
    "data" group: every rank makes the same calls and gets the same
    results."""

    def __init__(self, index: FeatureIndex, avg, counts, batch=None, group=None):
        if index.shard_spec is not None and group is None:
            raise ValueError("a resident table over a shard needs the data group")
        self.index = index
        self.avg = avg        # f32[S, Npad] device (the shard's n_local)
        self.counts = counts  # i32[S, Npad] device
        # (avg_q f32[Q,S,Npad], counts_q, qi) when this table is one row of
        # a batched poll group (compute_similarities_multi): optimize_many /
        # round_scores_many then serve the whole group with one download
        self.batch = batch
        self.group = group

    def _positions(self, clip_ids: Sequence[int]) -> list[int]:
        out = []
        for cid in clip_ids:
            pos = self.index.position(cid)
            if pos is not None:
                out.append(pos)
        return out

    def optimize(
        self, reviewed_labels: Mapping[int, float], hp: HyperParams
    ) -> tuple[HyperParams, GridResult]:
        """SimilarityTable.optimize semantics; the reviewed similarities are
        gathered on device and downloaded alone."""
        positions, labels = _reviewed_positions(self.index, reviewed_labels)
        sim = _reviewed_rows(self.index, self.group, self.avg[None],
                             np.asarray([positions], np.int64))[0]
        return _round_state(hp, sim, labels)

    def round_scores(
        self,
        weights: Mapping[str, float],
        threshold: float,
        near_miss: float,
        keep_ids: Sequence[int] = (),
        user_match_ids: Sequence[int] = (),
        finalize: bool = False,
        caps: Sequence[int] = _CAPS,
    ) -> dict[int, float] | None:
        """Reduced {clip_id: score} covering the selection band and the kept
        clips, in canonical ascending-clip-id order with the same float64
        score bits as SimilarityTable.scores.

        The candidate download is cap-sized, so caps escalate: a wide band
        retries at the next cap, and a band wider than every cap returns
        None — the caller then falls back to the full-table download."""
        for cap in caps:
            out = self._round_scores_once(weights, threshold, near_miss,
                                          keep_ids, user_match_ids,
                                          finalize, cap)
            if out is not None:
                return out
        return None

    def _banded_args(self, weights, keep_ids, user_match_ids,
                     keep_bucket: int = 0, um_bucket: int = 0):
        """Host-side argument prep shared by the solo and group paths."""
        w = np.asarray([weights[st] for st in self.index.streams], np.float64)
        keep_pos, n_keep = _pad_positions(self._positions(keep_ids),
                                          at_least=keep_bucket)
        um_pos, n_um = _pad_positions(self._positions(user_match_ids),
                                      at_least=um_bucket)
        um_mask = np.zeros(um_pos.shape[0], bool)
        um_mask[:n_um] = True
        return w, keep_pos, n_keep, um_pos, um_mask

    def _unpack_banded(self, packed: np.ndarray, w: np.ndarray,
                       keep_pos: np.ndarray, n_keep: int, cap: int
                       ) -> dict[int, float] | None:
        """Turn one packed row (see _banded_core) into the reduced
        ascending-clip-id float64 scores dict, or None on band overflow."""
        s = len(self.index.streams)
        cand_sz = (s + 2) * cap
        keep_sz = (s + 1) * keep_pos.shape[0]
        cand = packed[:cand_sz].reshape(s + 2, cap)
        keep = packed[cand_sz:cand_sz + keep_sz].reshape(s + 1, -1)
        n_cand = int(round(packed[-1]))
        if n_cand > cap:
            return None
        pos_score: dict[int, float] = {}
        cvalid = cand[s] > 0.5
        cpos = np.rint(cand[s + 1]).astype(np.int64)
        cscores = _scores_f64(cand[:s].astype(np.float32), w)
        for p, sc in zip(cpos[cvalid].tolist(), cscores[cvalid].tolist()):
            pos_score[p] = sc
        kvalid = keep[s, :n_keep] > 0.5
        kscores = _scores_f64(keep[:s, :n_keep].astype(np.float32), w)
        for p, ok, sc in zip(keep_pos[:n_keep].tolist(), kvalid.tolist(),
                             kscores.tolist()):
            if ok:
                pos_score[p] = sc
        ids = np.asarray(self.index.clip_ids)
        return {int(ids[p]): pos_score[p] for p in sorted(pos_score)}

    def _round_scores_once(self, weights, threshold, near_miss, keep_ids,
                           user_match_ids, finalize: bool, cap: int
                           ) -> dict[int, float] | None:
        w, keep_pos, n_keep, um_pos, um_mask = self._banded_args(
            weights, keep_ids, user_match_ids)
        packed = _band_rows(self.index, self.group, self.avg[None], self.counts[None],
                            w[None], [threshold], [near_miss], keep_pos[None],
                            um_pos[None], um_mask[None], finalize, cap)[0]
        return self._unpack_banded(packed, w, keep_pos, n_keep, cap)

    def to_table(self) -> SimilarityTable:
        """Full-download fallback (identical to compute_similarities); on a
        shard, the whole table all-gathered."""
        avg, counts = self.avg, self.counts
        if self.index.shard_spec is not None:
            avg = all_gather_cat(avg, self.group, dim=1)
            counts = all_gather_cat(counts, self.group, dim=1)
        return SimilarityTable(self.index, avg.cpu().numpy(), counts.cpu().numpy())


def _shared_batch(tables: Sequence[ResidentTable]):
    """The common batch parent of a poll group's tables, or None."""
    if not tables or tables[0].batch is None:
        return None
    parent = tables[0].batch[0]
    for t in tables:
        if t.batch is None or t.batch[0] is not parent:
            return None
    return tables[0].batch[:2]


def optimize_many(
    tables: Sequence[ResidentTable],
    labels_list: Sequence[Mapping[int, float]],
    hp: HyperParams,
) -> list[tuple[HyperParams, GridResult]]:
    """Batched ResidentTable.optimize across one poll group: every query's
    reviewed rows are gathered in ONE device op and downloaded in ONE copy.
    The per-query grid optimization stays host-side float64 — bit-identical
    to solo optimize (the gather moves bits, it computes nothing)."""
    if not tables:
        return []
    shared = _shared_batch(tables)
    if shared is None or len(tables) == 1:
        return [t.optimize(labels, hp)
                for t, labels in zip(tables, labels_list)]
    avg_q, _ = shared
    per = [_reviewed_positions(t.index, labels)
           for t, labels in zip(tables, labels_list)]
    m_bucket = max(_pad_positions(p)[0].shape[0] for p, _ in per)
    pos_q = np.zeros((len(tables), m_bucket), np.int64)
    sel = np.zeros(len(tables), np.int64)
    for qi, (table, (positions, _)) in enumerate(zip(tables, per)):
        pos_q[qi], _ = _pad_positions(positions, at_least=m_bucket)
        sel[qi] = table.batch[2]
    rows = avg_q[torch.from_numpy(sel).to(avg_q.device)]        # [Q, S, N]
    sims = _reviewed_rows(tables[0].index, tables[0].group, rows, pos_q)  # [Q, S, M]
    return [_round_state(hp, sims[qi][:, :len(positions)], lab)
            for qi, (positions, lab) in enumerate(per)]


def round_scores_many(
    tables: Sequence[ResidentTable],
    rounds: Sequence[Mapping],
    caps: Sequence[int] = _CAPS,
) -> list[dict[int, float] | None]:
    """Batched ResidentTable.round_scores across one poll group: the banded
    candidates of every query come back in ONE download per finalize-flavor
    (_banded_core is shared with the solo path and is row-independent, so
    each row is bit-identical to a solo round).

    rounds[i]: {weights, threshold, near_miss, keep_ids, user_match_ids,
    finalize}. A query whose band overflows the group cap retries solo at
    the escalated caps; None means wider than every cap (caller falls back
    to the full-table download), exactly like solo round_scores."""
    shared = _shared_batch(tables)
    if shared is None or len(tables) == 1:
        return [
            t.round_scores(r["weights"], r["threshold"], r["near_miss"],
                           r["keep_ids"], r["user_match_ids"],
                           finalize=r["finalize"], caps=caps)
            for t, r in zip(tables, rounds)
        ]
    results: list = [None] * len(tables)
    avg_q, counts_q = shared
    dev = avg_q.device
    by_flavor: dict[bool, list[int]] = {}
    for i, r in enumerate(rounds):
        by_flavor.setdefault(bool(r["finalize"]), []).append(i)
    for finalize, idxs in by_flavor.items():
        args = [tables[i]._banded_args(
            rounds[i]["weights"], rounds[i]["keep_ids"],
            rounds[i]["user_match_ids"]) for i in idxs]
        keep_bucket = max(a[1].shape[0] for a in args)
        um_bucket = max(a[3].shape[0] for a in args)
        args = [tables[i]._banded_args(
            rounds[i]["weights"], rounds[i]["keep_ids"],
            rounds[i]["user_match_ids"], keep_bucket, um_bucket)
            for i in idxs]
        sel = torch.tensor([tables[i].batch[2] for i in idxs], device=dev)
        packed = _band_rows(
            tables[0].index, tables[0].group, avg_q[sel], counts_q[sel],
            np.stack([a[0] for a in args]),
            [rounds[i]["threshold"] for i in idxs],
            [rounds[i]["near_miss"] for i in idxs],
            np.stack([a[1] for a in args]), np.stack([a[3] for a in args]),
            np.stack([a[4] for a in args]), finalize, caps[0])
        for row, (i, (w, keep_pos, n_keep, _up, _um)) in enumerate(
                zip(idxs, args)):
            out = tables[i]._unpack_banded(packed[row], w, keep_pos, n_keep,
                                           caps[0])
            if out is None and len(caps) > 1:  # overflow: solo escalation
                r = rounds[i]
                out = tables[i].round_scores(
                    r["weights"], r["threshold"], r["near_miss"],
                    r["keep_ids"], r["user_match_ids"],
                    finalize=r["finalize"], caps=caps[1:])
            results[i] = out
    return results


class SearchEngine:
    """Two numerics modes:

    - default: float32 on the index's device through K1 — the performance
      path;
    - exact=True: float64 on host BLAS — bit-comparable to the reference's
      numpy math for parity validation and small corpora. Requires the index
      to have been built with keep_host=True.

    With ``mesh`` (a (data, model) ``DeviceMesh`` over an initialized world,
    ``core/meshes.py``) the engine keeps only this rank's "data" shard of
    ``index`` on the mesh's device (a view on a world of one), runs K1 on
    it, and every call is a collective over the "data" group whose results
    are the unsharded engine's (module docstring). Every rank makes the
    same calls. A shard (``FeatureIndex.shard``) is refused: pass the whole
    index and the mesh.
    """

    def __init__(self, index: FeatureIndex, exact: bool = False, mesh=None):
        if index.shard_spec is not None:
            raise ValueError(
                f"the index is a shard ({index.shard_spec}); pass the whole index "
                "and mesh=..., and SearchEngine(index, mesh=mesh) shards it over "
                "the mesh's data axis")
        if exact and index.host_feats is None:
            raise ValueError("exact mode needs FeatureIndex.build(keep_host=True)")
        self.group = None
        if mesh is not None:
            if exact:
                raise ValueError("exact mode is the host float64 path; it takes no mesh")
            rank, world = data_rank_and_size(mesh)
            self.group = mesh.get_group(DATA_AXIS)
            # raises ValueError unless world divides the padded clip axis
            index = index.shard(rank, world, mesh_device(mesh))
        self.index = index
        self.exact = exact

    def compute_similarities(
        self, target: Mapping[str, Mapping[int, list]]
    ) -> SimilarityTable:
        if self.exact:
            return self._compute_similarities_host(target)
        return self.compute_similarities_multi([target])[0]

    def compute_similarities_resident(
        self, target: Mapping[str, Mapping[int, list]]
    ) -> ResidentTable:
        """Big-corpus flavor: the similarity table stays on the device (see
        ResidentTable). Device path only."""
        if self.exact:
            raise ValueError("the resident table is the f32 device path; "
                             "exact mode downloads the full float64 table")
        return self.compute_similarities_multi([target], resident=True)[0]

    def compute_similarities_multi(
        self,
        targets: Sequence[Mapping[str, Mapping[int, list]]],
        resident: bool = False,
    ) -> list:
        """Q concurrent query targets against the shared index in ONE K1
        launch (scoring.ensemble_similarities_batched). Returns one
        SimilarityTable (or ResidentTable, resident=True) per target, in
        order. K1's per-query bits do not depend on Q, so a query processed
        alone and in a batch give IDENTICAL similarities; Q needs no padding.
        Sharded: one K1 launch on the shard; a SimilarityTable is the
        all-gathered [S, N_pad] of the whole index on every rank."""
        if self.exact:
            raise ValueError("exact mode scores targets host-side one at a "
                             "time (SearchEngine.compute_similarities)")
        q = len(targets)
        if q == 0:
            return []
        idx = self.index
        avg, counts = ensemble_similarities_batched(*pack_targets(idx, targets),
                                                    idx.feats, idx.mask)
        if resident:
            return [ResidentTable(idx, avg[qi], counts[qi],
                                  batch=(avg, counts, qi), group=self.group)
                    for qi in range(q)]
        if self.group is not None:
            avg = all_gather_cat(avg, self.group, dim=2)
            counts = all_gather_cat(counts, self.group, dim=2)
        avg_h, counts_h = avg.cpu().numpy(), counts.cpu().numpy()
        return [SimilarityTable(idx, avg_h[qi], counts_h[qi])
                for qi in range(q)]

    def _compute_similarities_host(self, target) -> SimilarityTable:
        targets, tmask = self.index.target_arrays_host(target)
        feats, mask = self.index.host_feats, self.index.host_mask
        s, k, n, _ = feats.shape
        sims = np.empty((s, k, n), np.float64)
        for si in range(s):
            for ki in range(k):
                sims[si, ki] = feats[si, ki] @ targets[si, ki]
        m = mask & tmask[:, :, None]
        counts = m.sum(axis=1).astype(np.int32)
        avg = np.where(m, sims, 0.0).sum(axis=1) / np.maximum(counts, 1)
        return SimilarityTable(self.index, avg, counts)
