"""The data-sharded serving program's test world and its in-process form.

- ``cone_world``: a seeded index whose clips fan out on a cone around one
  direction (``tests/test_torch_engine.py``'s world), their angles dealt to
  positions in a seeded random order, so that the match and near-miss band
  of a round holds clips on every shard of the clip axis. One clip in 7
  misses a flow split, one in 23 its whole rgb stream (never scored).
- ``InProcessShards``: the sharded engine's steps rank by rank in one
  process, with no collective: R row shards of the index each scored by
  K1, then the tables concatenated, the reviewed and kept clips selected
  from their owners, finalize's lowest user match the minimum over the
  shards and the banded rows merged by ``search.engine.merge_banded``.
  The tests and ``chip_smoke.py`` hold it against the unsharded engine.
- ``serving_world``: one run of the serving program (table, resident
  rounds solo and batched, optimize, selection) through
  ``SearchEngine(index, mesh=mesh)``, or without a mesh, as JSON-able
  results; ``compare_serving`` lists where two runs differ. The
  multi-process worker and ``videoquery_torch.tools.dryrun`` run it.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Mapping, Sequence

import numpy as np
import torch

from videoquery_torch.core.config import HyperParams, compute_eps
from videoquery_torch.index.store import FeatureIndex, ShardSpec
from videoquery_torch.search.engine import (SearchEngine, _banded_args,
                                            _local_low, _local_rows, _round_state,
                                            _reviewed_positions, _scores_f64,
                                            _unpack_banded, merge_banded,
                                            optimize_many, pack_targets,
                                            round_scores_many, select_owned)
from videoquery_torch.search.scoring import ensemble_similarities_batched
from videoquery_torch.search.selection import (finalize_near_miss,
                                               lowest_scoring_user_match,
                                               select_clips_to_review)

STREAMS = ("rgb", "warped_optical_flow")
SPLITS = (1, 2, 3)
# the CPU's plain K1 sums a shard's products through host BLAS, whose
# blocking may follow the number of rows: a shard's similarities can then
# differ from the whole index's in the last f32 ulp (up to 1.4e-6 measured
# at D <= 32 and fewer than 64 rows a shard; none at the worlds' sizes).
# The card's K1 sums each product in an order fixed by D alone: exact there.
CPU_TOL = 2e-6


@dataclasses.dataclass
class ConeWorld:
    index: FeatureIndex
    targets: list[dict]      # Q target dicts {stream: {split: list}}
    thetas: np.ndarray       # f64[N]: clip at position p lies thetas[p] off the axis


def cone_world(n_clips: int, dim: int, n_queries: int, *, device, seed: int = 0,
               dtype: torch.dtype = torch.float32, pad_multiple: int = 8) -> ConeWorld:
    """The cone world on ``device``: clip ids 10 p + 3 at position p, each
    member at cos(t) u + sin(t) w with t the clip's angle (0 to 1.3, dealt
    in a random order) plus N(0, 0.03^2) and w a random unit vector normal
    to u; query q's members 0.05 (q + 1) off u, query 2 without split 3.
    The features are drawn on the device by a torch.Generator of ``seed``,
    one (stream, split) at a time; u, the angles and the targets by numpy."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(dim)
    u /= np.linalg.norm(u)
    thetas = np.linspace(0.0, 1.3, n_clips)[rng.permutation(n_clips)]

    def cone(theta):
        w = rng.standard_normal(dim)
        w -= w @ u * u
        w /= np.linalg.norm(w)
        return (np.cos(theta) * u + np.sin(theta) * w).tolist()

    targets = [{s: {k: cone(0.05 * (q + 1)) for k in SPLITS if not (q == 2 and k == 3)}
                for s in STREAMS} for q in range(n_queries)]
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    n_pad = -(-n_clips // pad_multiple) * pad_multiple
    feats = torch.zeros((len(STREAMS), len(SPLITS), n_pad, dim), dtype=dtype, device=device)
    u_t = torch.tensor(u, dtype=torch.float32, device=device)
    th = torch.tensor(thetas, dtype=torch.float32, device=device)
    for si in range(len(STREAMS)):
        for ki in range(len(SPLITS)):
            t = th + 0.03 * torch.randn(n_clips, generator=g, device=device)
            w = torch.randn((n_clips, dim), generator=g, device=device)
            w -= (w @ u_t)[:, None] * u_t
            w /= w.norm(dim=1, keepdim=True)
            w *= torch.sin(t)[:, None]
            w += torch.cos(t)[:, None] * u_t
            feats[si, ki, :n_clips] = w.to(dtype)
            del w
    pos = torch.arange(n_pad, device=device)
    real = pos < n_clips
    mask = real.expand(len(STREAMS), len(SPLITS), n_pad).clone()
    mask[1, 1] &= pos % 7 != 3        # a missing flow split: averaged over two
    mask[0] &= (pos % 23 != 5)[None]  # a missing rgb stream: never scored
    index = FeatureIndex(10 * np.arange(n_clips, dtype=np.int64) + 3, feats, mask,
                         STREAMS, SPLITS, "global_pool")
    return ConeWorld(index, targets, thetas)


class InProcessShards:
    """The sharded engine's results from R row shards scored in this
    process (module docstring). ``avgs`` / ``counts``: per shard, f32 / i32
    [Q, S, n_local] on one device; ``from_index`` scores them with K1, one
    shard at a time (each shard's copy freed before the next is made)."""

    def __init__(self, index: FeatureIndex, avgs: Sequence[torch.Tensor],
                 counts: Sequence[torch.Tensor]):
        self.index = index   # the whole index: clip ids, positions, streams
        self.avgs, self.counts = list(avgs), list(counts)
        r = len(self.avgs)
        self.specs = [ShardSpec(i, r, index.n_padded // r) for i in range(r)]

    @staticmethod
    def from_index(index: FeatureIndex, targets: Sequence[Mapping], n_shards: int
                   ) -> "InProcessShards":
        avgs, counts = [], []
        for r in range(n_shards):
            shard = index.shard(r, n_shards, index.device)
            a, c = ensemble_similarities_batched(*pack_targets(shard, targets),
                                                 shard.feats, shard.mask)
            avgs.append(a)
            counts.append(c)
            del shard
        return InProcessShards(index, avgs, counts)

    def table(self, qi: int) -> tuple[np.ndarray, np.ndarray]:
        """(avg f32[S, N_pad], counts i32[S, N_pad]) of query qi."""
        return (torch.cat([a[qi] for a in self.avgs], dim=1).cpu().numpy(),
                torch.cat([c[qi] for c in self.counts], dim=1).cpu().numpy())

    def optimize(self, qi: int, reviewed_labels: Mapping[int, float], hp: HyperParams):
        positions, labels = _reviewed_positions(self.index, reviewed_labels)
        pos = np.asarray(positions, np.int64)
        got = []
        for spec, a in zip(self.specs, self.avgs):
            idx = torch.from_numpy(spec.local(pos)[0]).to(a.device)
            got.append(a[qi][:, idx].cpu().numpy())
        sim = select_owned(np.stack(got)[:, None], self.specs[0].locate(pos[None])[0])[0]
        return _round_state(hp, sim, labels)

    def round_scores(self, qi: int, weights: Mapping[str, float], threshold: float,
                     near_miss: float, keep_ids: Sequence[int] = (),
                     user_match_ids: Sequence[int] = (), finalize: bool = False,
                     caps: Sequence[int] = (32_768, 262_144)) -> dict[int, float] | None:
        """ResidentTable.round_scores over the R shards: each cap tried in
        turn, None when the whole band is wider than every cap."""
        w, keep_pos, n_keep, um_pos, um_mask = (a[0] for a in _banded_args(self.index, [{
            "weights": weights, "keep_ids": keep_ids, "user_match_ids": user_match_ids}]))
        for cap in caps:
            rows = self.band_rows(qi, w, threshold, near_miss, keep_pos, um_pos,
                                  um_mask, finalize, cap)
            merged = merge_banded(rows, len(self.index.streams), cap,
                                  self.specs[0].n_local, self.specs[0].locate(keep_pos)[0])
            out = _unpack_banded(self.index, merged, w, keep_pos, n_keep, cap)
            if out is not None:
                return out
        return None

    def band_rows(self, qi, w, threshold, near_miss, keep_pos, um_pos, um_mask,
                  finalize: bool, cap: int) -> np.ndarray:
        """The R shards' packed rows of query qi, f64[R, L] in rank order."""
        dev = self.avgs[0].device
        wt = torch.tensor(w[None], dtype=torch.float32, device=dev)
        thr = torch.tensor([threshold], dtype=torch.float32, device=dev)
        nm = torch.tensor([near_miss], dtype=torch.float32, device=dev)
        low = None
        if finalize:
            low = torch.stack([_local_low(a[qi][None], c[qi][None], wt, um_pos[None],
                                          um_mask[None], spec)
                               for spec, a, c in zip(self.specs, self.avgs, self.counts)]
                              ).amin(dim=0)
        return np.stack([
            _local_rows(a[qi][None], c[qi][None], wt, thr, nm, keep_pos[None], low, cap,
                        spec)[0].cpu().numpy().astype(np.float64)
            for spec, a, c in zip(self.specs, self.avgs, self.counts)])


def band_rounds(index: FeatureIndex, avg: np.ndarray, counts: np.ndarray,
                weights: Mapping[str, float], n_band: int, n_shards: int
                ) -> tuple[dict, dict, dict]:
    """Rounds of one query with a populated band, from the whole index's
    table (avg f32[S, N_pad], counts, on the host), for holding R shards
    against the whole index: (revise, finalize) round_scores arguments and
    reviewed labels.

    revise: the default near miss and the threshold whose near-miss bound
    is the n_band-th best score (a band of ~n_band clips), kept: the
    lowest-scoring scored clip of each shard. finalize: the
    threshold at the (n_band / 2)-th best, user matches the best clip and
    the lowest, the first clip ranked n_band or lower that lies on the last
    shard while the clip ranked just above it does not. Labels: each
    shard's 3 best clips match, its clips ranked 4 n_band and just below
    do not."""
    n = index.n_clips
    w = np.asarray([weights[s] for s in index.streams], np.float64)
    pos = np.flatnonzero((counts[:, :n] > 0).all(axis=0))
    sc = _scores_f64(avg[:, pos].astype(np.float32), w)
    order = pos[np.argsort(-sc, kind="stable")]
    score = dict(zip(pos.tolist(), sc.tolist()))
    owner = order // (index.n_padded // n_shards)
    ids = [int(c) for c in index.clip_ids[order]]
    keep = [ids[np.flatnonzero(owner == r)[-1]] for r in range(n_shards)]
    nm = HyperParams().near_miss_default
    # lower = threshold - nm (1 - threshold) at the n_band-th score
    revise = dict(weights=dict(weights), threshold=(score[int(order[n_band])] + nm) / (1 + nm),
                  near_miss=nm, keep_ids=keep, user_match_ids=[], finalize=False)
    low = next(i for i in range(n_band, len(order))
               if owner[i] == n_shards - 1 and owner[i - 1] != n_shards - 1)
    um = [ids[0], ids[low]]
    finalize = dict(revise, threshold=score[int(order[n_band // 2])], keep_ids=keep + um,
                    user_match_ids=um, finalize=True)
    labels = {}
    for r in range(n_shards):
        mine = np.flatnonzero(owner == r)
        labels.update({ids[i]: 1.0 for i in mine[:3]})
        labels.update({ids[i]: 0.0 for i in mine[mine >= 4 * n_band][:3]})
    return revise, finalize, labels


# -- the serving program of the multi-process world and the dry run ----------

SERVING_CLIPS, SERVING_DIM, SERVING_QUERIES = 160, 24, 3


def _halves(world: ConeWorld) -> tuple[list[int], list[int]]:
    """The clip ids of each half of the clip axis, nearest the axis first."""
    n = world.index.n_clips
    half = world.index.n_padded // 2
    order = np.argsort(world.thetas, kind="stable")
    first = [int(world.index.clip_ids[p]) for p in order if p < half]
    second = [int(world.index.clip_ids[p]) for p in order if half <= p < n]
    return first, second


def serving_world(device, mesh=None, pad_multiple: int = 16) -> dict:
    """The serving program over ``cone_world(160, 24, 3)`` through
    ``SearchEngine(index, mesh=mesh)`` (no mesh: the unsharded engine); on a
    mesh, every rank of the initialized world calls it. Reviewed, kept and
    user-matched clips lie in both halves of the clip axis; finalize's
    lowest user match in the second. Returns the tables, the optimizer's
    results, the rounds (batched and solo; clip ids as strings) and each
    round's selection."""
    world = cone_world(SERVING_CLIPS, SERVING_DIM, SERVING_QUERIES, device=device,
                       pad_multiple=pad_multiple)
    engine = SearchEngine(world.index, mesh=mesh)
    hp = HyperParams()
    tables = engine.compute_similarities_multi(world.targets)
    resident = engine.compute_similarities_multi(world.targets, resident=True)
    near_a, near_b = _halves(world)
    # the analyst's marks: the clips nearest the axis match, farther ones not
    labels = [{**{c: 1.0 for c in near_a[q:q + 5] + near_b[q:q + 5]},
               **{c: 0.0 for c in near_a[30 + q:35 + q] + near_b[30 + q:35 + q]}}
              for q in range(len(world.targets))]
    fitted = optimize_many(resident, labels, hp)
    # finalize: the user matches are the nearest clip of the first half and
    # the 41st nearest of the second, which scores below the threshold, so
    # the band's bound derives from it on the second half's rank only
    um = [near_a[0], near_b[40]]
    specs = [{"weights": h.weights, "threshold": h.threshold,
              "near_miss": hp.near_miss_default,
              "keep_ids": [near_a[60], near_b[60]] + (um if q % 2 else []),
              "user_match_ids": um if q % 2 else [], "finalize": q % 2 == 1}
             for q, (h, _) in enumerate(fitted)]
    many = round_scores_many(resident, specs)
    solo = [t.round_scores(r["weights"], r["threshold"], r["near_miss"], r["keep_ids"],
                           r["user_match_ids"], finalize=r["finalize"])
            for t, r in zip(resident, specs)]
    picks = []
    for got, r in zip(many, specs):
        user_matches, nm, max_n = {}, hp.near_miss_default, 10
        if r["finalize"]:
            user_matches = {str(c): True for c in r["user_match_ids"]}
            low, _ = lowest_scoring_user_match(got, user_matches)
            nm, max_n = finalize_near_miss(r["threshold"], low, compute_eps()), math.inf
        picks.append(select_clips_to_review(got, user_matches, near_a[60], r["threshold"],
                                            max_n, nm, rng=random.Random(3)))
    return {
        "avg": [t.avg_sim.tolist() for t in tables],
        "counts": [t.counts.tolist() for t in tables],
        "optimize": [[h.threshold, h.weights[STREAMS[1]], list(g.grid_index)]
                     for h, g in fitted],
        "rounds": [{str(c): v for c, v in d.items()} for d in many],
        "rounds_solo": [{str(c): v for c, v in d.items()} for d in solo],
        "picks": [[int(c) for c in p] for p in picks],
        "low_user_match_below_threshold": [
            bool(min(d[c] for c in um) < r["threshold"]) for d, r in zip(many, specs)
            if r["finalize"]],
    }


def compare_serving(got: dict, want: dict, exact: bool) -> list[str]:
    """Where two ``serving_world`` results differ: counts, rounds' clip
    ids and selections must be equal; similarities, scores and the
    optimizer's results bit for bit when ``exact``, else within CPU_TOL."""
    bad = []
    if got["counts"] != want["counts"]:
        bad.append("counts")
    if got["picks"] != want["picks"]:
        bad.append(f"selections {got['picks']} != {want['picks']}")
    for key in ("rounds", "rounds_solo"):
        for q, (a, b) in enumerate(zip(got[key], want[key])):
            if list(a) != list(b):
                bad.append(f"{key}[{q}] clip ids")
            elif not _close(list(a.values()), list(b.values()), exact):
                bad.append(f"{key}[{q}] scores")
    if not _close(got["avg"], want["avg"], exact):
        bad.append("avg")
    for q, (a, b) in enumerate(zip(got["optimize"], want["optimize"])):
        if a[2] != b[2] or not _close(a[:2], b[:2], exact):
            bad.append(f"optimize[{q}] {a} != {b}")
    return bad


def _close(a, b, exact: bool) -> bool:
    if exact:
        return a == b
    return bool(np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                            rtol=CPU_TOL, atol=CPU_TOL))
