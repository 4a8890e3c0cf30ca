"""Batched top-k queries, in a closed loop over the corpus world.

The traffic: a closed loop of batches of ``batch`` cone targets (clusters
drawn by the seed, at the mix's offsets) over the configuration's corpus,
each the top-``k`` of K1's scores epilogue (``kernels/query.py::
fused_query_topk``, what ``search/distributed.py::ShardedSearch`` runs on
its shard, here the whole index) under the default weights, then the
values and ids read back to the host. A batch is timed from the call until
both are on the host. The pool holds ``pool_batches`` distinct batches,
run in turn.

The check recomputes the sampled batches' scores with the plain reference
(targets rounded to the index's dtype, as the kernel casts them): the gap
between each returned value and the reference's score of its id, and the
ids that fall below the reference's k-th best by more than that limit.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import stats
from benchmark.loops import rounds
from benchmark.reference import corpus as ref


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, stages):
        self.config, self.traffic, self.stage = config, traffic, stages
        self.device = torch.device(device)
        self.world = rounds.make_corpus(config, traffic, seed, device)
        self.k = traffic["k"]
        b = traffic["batch"]
        offsets = traffic["target_offsets"]
        self.streams, self.splits = tuple(config["streams"]), tuple(config["splits"])
        self.pool = []
        for _ in range(traffic["pool_batches"]):
            targets = [rounds.worlds.slot_target(self.world, self.world.rng, i, offsets)[0]
                       for i in range(b)]
            self.pool.append(targets)
        w = [config["default_weights"][s] for s in self.streams]
        self.weights = torch.tensor([w] * b, dtype=torch.float32, device=self.device)
        # the targets as the program's caller packs them: f32 [B, S, K, D]
        self.packed = []
        for targets in self.pool:
            t, tm = ref.pack_targets(targets, self.streams, self.splits, config["feature_dim"])
            self.packed.append((t.float().to(self.device), tm.to(self.device)))
        rng = np.random.default_rng([seed, 2])
        self.check_batches = sorted(rng.choice(
            len(self.pool), min(traffic["check_batches"], len(self.pool)),
            replace=False).tolist())
        self.kept: dict[int, tuple] = {}
        self.latencies: list[float] = []
        self.attempted = self.failed = 0
        self.window_s = 0.0

    def _batch(self, i: int):
        from videoquery_torch.kernels.query import fused_query_topk

        t, tm = self.packed[i]
        with self.stage("query"):
            vals, ids = fused_query_topk(self.world.feats, self.world.mask, t, tm,
                                         self.weights, k=self.k)
            return vals.cpu(), ids.cpu()

    def warm(self) -> None:
        for i in range(min(self.traffic["warm_batches"], len(self.pool))):
            self._batch(i)

    def run(self, seconds: float) -> None:
        start = time.perf_counter()
        end = start + seconds
        n = 0
        while time.perf_counter() < end:
            i = n % len(self.pool)
            self.attempted += 1
            t0 = time.perf_counter()
            try:
                out = self._batch(i)
            except Exception as exc:
                self.failed += 1
                print(f"[query] batch {i} failed: {exc!r}", file=sys.stderr)
            else:
                self.latencies.append(time.perf_counter() - t0)
                if i in self.check_batches:
                    self.kept[i] = out
            n += 1
        self.window_s = time.perf_counter() - start

    def end_to_end(self) -> dict:
        return {"query_ms_p95": stats.percentile([x * 1e3 for x in self.latencies], 95)}

    def work(self) -> dict:
        s, k, n, d = self.world.feats.shape
        return {"batches": len(self.latencies), "q": self.weights.shape[0], "k": self.k,
                "members": s * k, "n_padded": n, "dim": d,
                "feat_bytes": self.world.feats.element_size(), "streams": s}

    def release(self) -> None:
        pass

    def check(self, limits: dict) -> dict:
        if not self.kept:
            raise RuntimeError("no sampled batch completed in the window")
        r = {"value_gap": 0.0, "rank_faults": 0}
        for i, (vals, ids) in sorted(self.kept.items()):
            got = judge_batch(self, i, vals, ids, limits["value_gap"])
            r["value_gap"] = max(r["value_gap"], got["value_gap"])
            r["rank_faults"] += got["rank_faults"]
        return {k: {"value": v, "limit": limits[k]} for k, v in r.items()}


def reference_scores(cell: Cell, i: int, cast=None) -> torch.Tensor:
    """f64 [B, N] scores of batch i's targets, rounded to the index dtype."""
    t, tm = ref.pack_targets(cell.pool[i], cell.streams, cell.splits,
                             cell.config["feature_dim"], round_to=cell.world.feats.dtype)
    avg, counts = ref.similarities(cell.world.feats, cell.world.mask, t, tm, cast)
    return ref.scores(avg, counts, cell.weights.double())[:, :cell.world.n_clips]


def judge_batch(cell: Cell, i: int, vals, ids, tol: float) -> dict:
    """Batch i's readings: the widest gap of a returned value and the count
    of ids below the reference's k-th best by more than ``tol``, or
    repeated."""
    sc = reference_scores(cell, i).cpu()
    ids = ids.long()
    at = torch.gather(sc, 1, ids.clamp(max=sc.shape[1] - 1))
    at = torch.where(ids < sc.shape[1], at, torch.tensor(-torch.inf, dtype=at.dtype))
    gap = float((vals.double() - at).abs().max())
    kth = torch.topk(sc, cell.k, dim=1).values[:, -1:]
    faults = int((at < kth - tol).sum())
    faults += sum(len(row) - len(set(row)) for row in ids.tolist())
    return {"value_gap": gap, "rank_faults": faults}


def control_output(cell: Cell, i: int, cast):
    """The reference in the program's place, its index cast: (values,
    ids) of batch i."""
    sc = reference_scores(cell, i, cast).cpu()
    vals, ids = torch.topk(sc, cell.k, dim=1)
    return vals.float(), ids
