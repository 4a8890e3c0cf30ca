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
from videoquery_torch.core.profiling import count, span
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
    are the same whatever B is: a group of one and a larger group agree."""
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
    """The packed rows (global positions) of B queries over the engine's
    index: f32[B, L] as ``_banded_core`` wrote them, whose positions are
    exact below 2^24; on a shard, the rows of the whole index on every rank,
    f64[L] each: the user matches' minimum all-reduced, the shards' rows
    all-gathered over ``group`` and merged (``merge_banded``), whose
    ``rank * n_local`` offsets need f64."""
    dev = avg.device
    spec = index.shard_spec
    with span("engine.band_rows"):
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
        # the candidate slots downloaded: cap a query from each shard
        count("engine.band_slots", avg.shape[0] * cap * (1 if spec is None else spec.world))
        if spec is None:
            return rows.cpu().numpy()
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


def _pad_positions(pos_lists: Sequence[Sequence[int]], multiple: int = 8
                   ) -> tuple[np.ndarray, list[int]]:
    """B position lists -> int64[B, M] and their lengths, each row padded
    with position 0 (filler, never read back) to the longest list rounded
    up to a multiple of 8, at least 8, so a group shares one shape."""
    n = [len(p) for p in pos_lists]
    out = np.zeros((len(n), max(multiple, -(-max(n) // multiple) * multiple)), np.int64)
    for i, p in enumerate(pos_lists):
        if p:
            out[i, :n[i]] = p
    return out, n


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


def _positions(index: FeatureIndex, clip_ids: Sequence[int]) -> list[int]:
    """The index positions of the clip ids in the index, in order."""
    out = []
    for cid in clip_ids:
        pos = index.position(cid)
        if pos is not None:
            out.append(pos)
    return out


def _banded_args(index: FeatureIndex, rounds: Sequence[Mapping]):
    """The host-side arguments of B rounds over ``index`` (each round's
    weights, keep_ids and user_match_ids), each built once: the weight
    vectors f64[B, S], the kept positions int64[B, K] and their numbers,
    the user-match positions int64[B, U] and their mask bool[B, U]."""
    w = np.array([[r["weights"][st] for st in index.streams] for r in rounds], np.float64)
    keep_pos, n_keep = _pad_positions([_positions(index, r["keep_ids"]) for r in rounds])
    um_pos, n_um = _pad_positions([_positions(index, r["user_match_ids"]) for r in rounds])
    um_mask = np.zeros(um_pos.shape, bool)
    for i, n in enumerate(n_um):
        um_mask[i, :n] = True
    return w, keep_pos, n_keep, um_pos, um_mask


def _unpack_banded(index: FeatureIndex, packed: np.ndarray, w: np.ndarray,
                   keep_pos: np.ndarray, n_keep: int, cap: int
                   ) -> dict[int, float] | None:
    """Turn one packed row (see _banded_core; f32, or f64 from
    merge_banded) into the reduced ascending-clip-id float64 scores dict,
    or None on band overflow. Only the live prefix is read: the in-band
    positions fill the first n_cand slots, ascending."""
    with span("engine.band_unpack"):
        s = len(index.streams)
        n_cand = int(packed[-1])
        if n_cand > cap:
            return None
        count("engine.band_clips", n_cand)
        cand_sz = (s + 2) * cap
        cand = packed[:cand_sz].reshape(s + 2, cap)[:, :n_cand]
        keep_sz = (s + 1) * keep_pos.shape[0]
        keep = packed[cand_sz:cand_sz + keep_sz].reshape(s + 1, -1)[:, :n_keep]
        cvalid, kvalid = cand[s] > 0.5, keep[s] > 0.5
        pos = np.concatenate([cand[s + 1, cvalid].astype(np.int64),
                              keep_pos[:n_keep][kvalid]])
        avg = np.concatenate([cand[:s, cvalid], keep[:s, kvalid]], axis=1)
        scores = _scores_f64(avg.astype(np.float32, copy=False), w)
        # a kept clip in the band comes twice, with the same bits
        pos, first = np.unique(pos, return_index=True)
        return dict(zip(index.clip_ids[pos].tolist(), scores[first].tolist()))


class ResidentTable:
    """Device-resident similarity table: the big-corpus round.

    avg/counts stay on the device. optimize() downloads only the reviewed
    rows ([S, M] for M reviewed clips); round_scores() downloads only the
    banded candidates plus kept clips, returning the reduced ascending-clip-id
    scores dict that select_clips_to_review needs — its exact float64 band
    filtering makes the selection identical to the full-download path. Both
    are a poll group of one (optimize_many, round_scores_many).

    On a shard of the index (a sharded SearchEngine), avg/counts are the
    shard's and every method is a collective over ``group``, the mesh's
    "data" group: every rank makes the same calls and gets the same
    results."""

    def __init__(self, index: FeatureIndex, avg, counts, group=None):
        if index.shard_spec is not None and group is None:
            raise ValueError("a resident table over a shard needs the data group")
        self.index = index
        self.avg = avg        # f32[S, Npad] device (the shard's n_local)
        self.counts = counts  # i32[S, Npad] device
        self.group = group

    def optimize(
        self, reviewed_labels: Mapping[int, float], hp: HyperParams
    ) -> tuple[HyperParams, GridResult]:
        """SimilarityTable.optimize semantics; the reviewed similarities are
        gathered on device and downloaded alone."""
        return optimize_many([self], [reviewed_labels], hp)[0]

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
        return round_scores_many([self], [{
            "weights": weights, "threshold": threshold, "near_miss": near_miss,
            "keep_ids": keep_ids, "user_match_ids": user_match_ids,
            "finalize": finalize}], caps)[0]

    def to_table(self) -> SimilarityTable:
        """Full-download fallback (identical to compute_similarities); on a
        shard, the whole table all-gathered."""
        avg, counts = self.avg, self.counts
        if self.index.shard_spec is not None:
            avg = all_gather_cat(avg, self.group, dim=1)
            counts = all_gather_cat(counts, self.group, dim=1)
        return SimilarityTable(self.index, avg.cpu().numpy(), counts.cpu().numpy())


def _stacked(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """[B, S, N] of B tables' rows [S, N] on the device: a view of a group
    of one, else one copy of the B rows."""
    return rows[0][None] if len(rows) == 1 else torch.stack(list(rows))


def _shared_index(tables: Sequence[ResidentTable]) -> tuple[FeatureIndex, object]:
    """The index and the group that every table of a poll group is over:
    the rows' positions map to clip ids through the one index."""
    index, group = tables[0].index, tables[0].group
    if any(t.index is not index or t.group is not group for t in tables):
        raise ValueError("a poll group's tables must share one index and one group")
    return index, group


def optimize_many(
    tables: Sequence[ResidentTable],
    labels_list: Sequence[Mapping[int, float]],
    hp: HyperParams,
) -> list[tuple[HyperParams, GridResult]]:
    """SimilarityTable.optimize across a poll group of any size, whose
    tables share one index and one group (else ValueError): every query's
    reviewed rows are gathered in ONE device op and downloaded in ONE copy.
    The per-query grid optimization stays host-side float64 — the same
    bits whatever the group (the gather moves bits, it computes nothing)."""
    if not tables:
        return []
    index, group = _shared_index(tables)
    with span("optimizer"):
        per = [_reviewed_positions(index, labels) for labels in labels_list]
        pos_q, n = _pad_positions([positions for positions, _ in per])
        with span("optimizer.fetch"):
            sims = _reviewed_rows(index, group, _stacked([t.avg for t in tables]),
                                  pos_q)  # [Q, S, M]
        with span("optimizer.grid"):
            return [_round_state(hp, sims[qi][:, :n[qi]], lab)
                    for qi, (_, lab) in enumerate(per)]


def round_scores_many(
    tables: Sequence[ResidentTable],
    rounds: Sequence[Mapping],
    caps: Sequence[int] = _CAPS,
) -> list[dict[int, float] | None]:
    """ResidentTable.round_scores across a poll group of any size, whose
    tables share one index and one group (else ValueError): the banded
    candidates of every query come back in ONE download per finalize-flavor
    and cap (_banded_core is row-independent, so each row has the bits of a
    group of one).

    rounds[i]: {weights, threshold, near_miss, keep_ids, user_match_ids,
    finalize}. The queries whose band overflows a cap retry together at
    the next; None means wider than every cap (the caller falls back to the
    full-table download). On a shard the overflow is read from the merged
    rows, the same on every rank, so every rank makes the same calls."""
    if not tables:
        return []
    index, group = _shared_index(tables)
    results: list = [None] * len(tables)
    with span("engine.banded"):
        by_flavor: dict[bool, list[int]] = {}
        for i, r in enumerate(rounds):
            by_flavor.setdefault(bool(r["finalize"]), []).append(i)
        for finalize, idxs in by_flavor.items():
            w, keep_pos, n_keep, um_pos, um_mask = _banded_args(
                index, [rounds[i] for i in idxs])
            live = idxs  # the rounds still to band, one row each
            for cap in caps:
                packed = _band_rows(
                    index, group, _stacked([tables[i].avg for i in live]),
                    _stacked([tables[i].counts for i in live]), w,
                    [rounds[i]["threshold"] for i in live],
                    [rounds[i]["near_miss"] for i in live],
                    keep_pos, um_pos, um_mask, finalize, cap)
                over = []
                for row, i in enumerate(live):
                    results[i] = _unpack_banded(index, packed[row], w[row], keep_pos[row],
                                                n_keep[row], cap)
                    if results[i] is None:
                        over.append(row)
                if not over:
                    break
                # only the overflowing rows go on to the next cap
                live = [live[row] for row in over]
                w, keep_pos, um_pos, um_mask = (a[over] for a in (w, keep_pos, um_pos, um_mask))
                n_keep = [n_keep[row] for row in over]
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
        with span("engine.similarity"):
            avg, counts = ensemble_similarities_batched(*pack_targets(idx, targets),
                                                        idx.feats, idx.mask)
        if resident:
            return [ResidentTable(idx, avg[qi], counts[qi], group=self.group)
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
