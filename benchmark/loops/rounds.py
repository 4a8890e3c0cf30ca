"""Revise rounds of a poll group, in a closed loop over the corpus world.

The traffic: a closed loop of broker poll groups, each of
``queries_per_group`` analysts' revise rounds over one search set (the
configuration's corpus, resident on the card). Each round carries
``reviewed_per_round`` reviewed clips of its query's cluster (the clusters
and the targets drawn by the seed), at angles spread evenly up to
``reviewed_angle_max`` off the axis, and labelled by the world's geometry:
a match where the clip lies within ``match_angle`` of the axis. The analyst's reference clip is the cluster's
scored clip nearest the axis; the confirmed matches are kept.

The window drives what ``service/compute_matches.py`` runs for a search
set of at least ``big_round_threshold`` clips: for a group of more than
one, ``SearchEngine.compute_similarities_multi(resident=True)``, then
``optimize_many``, ``round_scores_many`` and ``select_clips_to_review``
per query in drain order; for a group of one the per-table path,
``ResidentTable.optimize`` then ``round_scores``. A round is timed from the
start of its poll group until its selection is returned.

The pool holds ``groups`` distinct poll groups, run in turn. The check
recomputes the sampled groups' rounds with the plain reference: the scores
of the band (K1's similarities through the round's outputs), the fit (by
the reference's loss at the fitted point), the band's membership and the
selection's rules.
"""

from __future__ import annotations

import dataclasses
import os
import random
import sys
import time

import numpy as np
import torch

from benchmark import stats, world as worlds
from benchmark.reference import corpus as ref
from benchmark.reference import optimizer as ref_opt
from benchmark.reference import selection as ref_sel

# the program's device band is widened by this margin (search/engine.py
# _BAND_MARGIN): its downloaded candidates may reach this far below the band
BAND_MARGIN = 1e-5


@dataclasses.dataclass
class Group:
    targets: list[dict]
    labels: list[dict]          # {clip id: 0.0 / 1.0} of each round
    user_matches: list[dict]    # {str(clip id): bool}
    ref_ids: list[int]
    select_seeds: list[str]


@dataclasses.dataclass
class Output:
    weights: list[float]        # the second stream's fitted weight, a round
    thresholds: list[float]
    near_miss: list[float]
    scores: list[dict]          # the banded {clip id: score} of each round
    selections: list[list]


def hyperparams(config: dict):
    from videoquery_torch.core.config import HyperParams

    w0, w1, ws = config["weight_grid"]
    t0, t1, ts = config["threshold_grid"]
    return HyperParams(default_weights=dict(config["default_weights"]),
                       near_miss_default=config["near_miss_default"],
                       ballast=config["ballast"],
                       streams=tuple(config["streams"]),
                       weight_grid_start=w0, weight_grid_stop=w1, weight_grid_step=ws,
                       threshold_grid_start=t0, threshold_grid_stop=t1,
                       threshold_grid_step=ts)


def make_corpus(config: dict, traffic: dict, seed: int, device) -> worlds.World:
    w = traffic["world"]
    return worlds.make_world(config["n_segments"], config["feature_dim"], w["n_clusters"],
                             w["angle_max"], w["member_sigma"], seed, device,
                             config["dtype"], config["clip_pad_multiple"])


def make_group(world: worlds.World, traffic: dict, g: int, seed: int) -> Group:
    rng = world.rng
    q = traffic["queries_per_group"]
    offsets = traffic["target_offsets"]
    grp = Group([], [], [], [], [])
    for i in range(q):
        slot = i if q > 1 else g
        target, c = worlds.slot_target(world, rng, slot, offsets)
        members = np.flatnonzero((world.cluster == c) & world.valid)
        reviewed = reviewed_clips(world, members, traffic["reviewed_per_round"],
                                  traffic["reviewed_angle_max"])
        match = world.theta[reviewed] <= traffic["match_angle"]
        ids = world.clip_ids[reviewed]
        grp.targets.append(target)
        grp.labels.append({int(c_): float(m) for c_, m in zip(ids, match)})
        grp.user_matches.append({str(int(c_)): bool(m) for c_, m in zip(ids, match)})
        grp.ref_ids.append(int(world.clip_ids[members[np.argmin(world.theta[members])]]))
        grp.select_seeds.append(f"{seed}:{g}:{i}")
    return grp


def reviewed_clips(world: worlds.World, members: np.ndarray, n: int,
                   angle_max: float) -> np.ndarray:
    """The n members nearest the angles (j + 1/2) angle_max / n off the
    axis: every round reviews clips at the same angles, so that the fitted
    thresholds, and the bands, are of the same sizes whatever the seed."""
    order = members[np.argsort(world.theta[members])]
    theta = world.theta[order]
    want = (np.arange(n) + 0.5) / n * angle_max
    idx = np.clip(np.searchsorted(theta, want), 1, len(theta) - 1)
    idx -= (want - theta[idx - 1]) < (theta[idx] - want)
    return order[np.unique(idx)]


def round_spec(grp: Group, i: int, weights: dict, threshold: float, near_miss: float) -> dict:
    """The banded round's arguments, as ``compute_matches._round_spec``
    makes them for a revise job."""
    confirmed = [int(c) for c, v in grp.user_matches[i].items() if v is True]
    return {"weights": weights, "threshold": threshold, "near_miss": near_miss,
            "keep_ids": [grp.ref_ids[i]] + confirmed, "user_match_ids": confirmed,
            "finalize": False}


def sample_groups(traffic: dict, seed: int, first: int = 16) -> list[int]:
    """The pool's groups whose rounds the check recomputes, drawn by the
    seed among its first ``first`` groups (the pool's order is the seed's,
    and any window of a second or more runs them)."""
    rng = np.random.default_rng([seed, 1])
    m = min(first, traffic["groups"])
    return sorted(rng.choice(m, min(traffic["check_groups"], m), replace=False).tolist())


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, stages):
        from videoquery_torch.index.store import FeatureIndex
        from videoquery_torch.search.engine import SearchEngine

        os.environ["COMPUTE_EPS"] = repr(config["compute_eps"])
        self.config, self.traffic, self.stage = config, traffic, stages
        self.q = traffic["queries_per_group"]
        self.hp = hyperparams(config)
        self.world = make_corpus(config, traffic, seed, device)
        index = FeatureIndex(self.world.clip_ids, self.world.feats, self.world.mask,
                             tuple(config["streams"]), tuple(config["splits"]),
                             "global_pool")
        if index.n_padded < config["big_round_threshold"]:
            raise ValueError("the corpus is below big_round_threshold: the service "
                             "would take the full-download round")
        self.engine = SearchEngine(index)
        self.pool = [make_group(self.world, traffic, g, seed)
                     for g in range(traffic["groups"])]
        self.check_groups = sample_groups(traffic, seed)
        self.kept: dict[int, Output] = {}
        self.latencies: list[float] = []
        self.attempted = self.failed = 0
        self.groups_done = 0
        self.window_s = 0.0

    # -- the program's round ------------------------------------------------

    def _group(self, g: int) -> Output:
        from videoquery_torch.search.engine import optimize_many, round_scores_many
        from videoquery_torch.search.selection import select_clips_to_review

        grp, q, st = self.pool[g], self.q, self.stage
        t0 = time.perf_counter()
        with st("engine.similarity"):
            tables = self.engine.compute_similarities_multi(grp.targets, resident=True)
        with st("optimizer"):
            if q > 1:
                fits = optimize_many(tables, grp.labels, self.hp)
            else:
                fits = [tables[0].optimize(grp.labels[0], self.hp)]
        hps = [f[0] for f in fits]
        specs = [round_spec(grp, i, h.weights, h.threshold, h.near_miss_default)
                 for i, h in enumerate(hps)]
        with st("engine.banded"):
            if q > 1:
                scores = round_scores_many(tables, specs)
            else:
                s = specs[0]
                scores = [tables[0].round_scores(s["weights"], s["threshold"], s["near_miss"],
                                                 s["keep_ids"], s["user_match_ids"])]
            # a band wider than every cap: the full download, as compute_matches
            scores = [sc if sc is not None else t.to_table().scores(h.weights)
                      for sc, t, h in zip(scores, tables, hps)]
        out = Output([], [], [], scores, [])
        for i, h in enumerate(hps):
            with st("selection"):
                sel = select_clips_to_review(scores[i], grp.user_matches[i], grp.ref_ids[i],
                                             h.threshold, self.config["matches_per_round"],
                                             h.near_miss_default,
                                             rng=random.Random(grp.select_seeds[i]))
            self.latencies.append(time.perf_counter() - t0)
            out.weights.append(float(h.weights[self.config["streams"][1]]))
            out.thresholds.append(float(h.threshold))
            out.near_miss.append(float(h.near_miss_default))
            out.selections.append(list(sel))
        return out

    def warm(self) -> None:
        for g in range(min(self.traffic["warm_groups"], len(self.pool))):
            self._group(g)
        self.latencies.clear()

    def run(self, seconds: float) -> None:
        start = time.perf_counter()
        end = start + seconds
        g = 0
        while time.perf_counter() < end:
            k = g % len(self.pool)
            self.attempted += self.q
            try:
                out = self._group(k)
            except Exception as exc:  # a failed group counts its rounds failed
                self.failed += self.q
                print(f"[rounds] group {k} failed: {exc!r}", file=sys.stderr)
            else:
                if k in self.check_groups:
                    self.kept[k] = out
            g += 1
        self.groups_done = g
        self.window_s = time.perf_counter() - start

    def end_to_end(self) -> dict:
        return {"round_ms_p95": stats.percentile([x * 1e3 for x in self.latencies], 95)}

    def work(self) -> dict:
        feats = self.world.feats
        s, k, n, d = feats.shape
        return {"poll_groups": self.groups_done, "q": self.q, "members": s * k,
                "n_padded": n, "dim": d, "feat_bytes": feats.element_size(),
                "streams": s}

    def release(self) -> None:
        self.engine = None

    # -- the check ------------------------------------------------------------

    def check(self, limits: dict) -> dict:
        """The numbers compared, each {"value", "limit"}: recomputed with
        the reference for every sampled group that the window ran."""
        if not self.kept:
            raise RuntimeError("no sampled poll group completed in the window")
        bands = [len(sc) for out in self.kept.values() for sc in out.scores]
        print(f"[rounds] {self.groups_done} poll groups; banded scores a round in the "
              f"sampled groups: min {min(bands)}, mean {np.mean(bands):.0f}, "
              f"max {max(bands)}", file=sys.stderr)
        readings = {"score_gap": 0.0, "fit_loss_gap": 0.0, "band_faults": 0,
                    "selection_faults": 0}
        for g, out in sorted(self.kept.items()):
            for name, value in judge_group(self.world, self.config, self.hp, self.pool[g],
                                           out, limits["score_gap"]).items():
                readings[name] = max(readings[name], value) if name.endswith("gap") \
                    else readings[name] + value
        return {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}


def reference_fits(world, config: dict, hp, grp: Group, cast=None):
    """The reference's similarities of a group's targets over the whole
    corpus (f64 [Q, S, N] and counts) and its fitted (weight, threshold)
    of each round."""
    t, tm = ref.pack_targets(grp.targets, config["streams"], config["splits"],
                             config["feature_dim"])
    avg, counts = ref.similarities(world.feats, world.mask, t, tm, cast)
    fits = []
    for i, labels in enumerate(grp.labels):
        pos = torch.tensor([(c - 3) // 10 for c in labels], device=avg.device)
        sim = avg[i][:, pos].cpu().numpy()
        y = np.asarray(list(labels.values()))
        fit = ref_opt.optimize_weights(sim, y, hp.weight_grid, hp.threshold_grid,
                                       hp.ballast, config["compute_eps"])
        fits.append((fit.weight, fit.threshold, sim, y))
    return avg, counts, fits


def judge_group(world, config: dict, hp, grp: Group, out: Output, tol: float) -> dict:
    """One group's readings: the widest gaps of its rounds and the count of
    faults in their bands and selections.

    The fit is judged by the reference's loss: at the program's (weight,
    threshold) against at the reference's own. The fitted point itself
    swings with the last bits of the similarities where the parabola's
    stencil is flat; the loss there does not."""
    avg, counts, fits = reference_fits(world, config, hp, grp)
    r = {"score_gap": 0.0, "fit_loss_gap": 0.0, "band_faults": 0, "selection_faults": 0}
    ids = world.clip_ids
    for i, (w_ref, th_ref, sim, y) in enumerate(fits):
        at_port = ref_opt.loss_at(sim, y, out.weights[i], out.thresholds[i], hp.ballast)
        at_ref = ref_opt.loss_at(sim, y, w_ref, th_ref, hp.ballast)
        r["fit_loss_gap"] = max(r["fit_loss_gap"], abs(at_port - at_ref))
        # the program's band, judged under its own fitted weights and threshold
        sc = ref.scores(avg[i], counts[i], [1.0, out.weights[i]])[:len(ids)].cpu().numpy()
        th, nm = out.thresholds[i], out.near_miss[i]
        lower = th - nm * (1.0 - th)
        port = out.scores[i]
        pos = (np.fromiter(port.keys(), np.int64, len(port)) - 3) // 10
        got = np.fromiter(port.values(), np.float64, len(port))
        if len(pos):
            r["score_gap"] = max(r["score_gap"], float(np.abs(got - sc[pos]).max()))
        spec = round_spec(grp, i, {}, th, nm)
        kept = set(spec["keep_ids"])
        in_port = np.zeros(len(ids), bool)
        in_port[pos] = True
        missing = np.flatnonzero((sc >= lower + tol) & ~in_port)
        extra = [p for p in pos.tolist()
                 if ids[p] not in kept and sc[p] < lower - BAND_MARGIN - tol]
        r["band_faults"] += len(missing) + len(extra)
        near = np.flatnonzero(sc >= lower - 2 * tol)
        ref_score = {int(ids[p]): float(sc[p]) for p in near}
        for c in kept:
            p = (c - 3) // 10
            if np.isfinite(sc[p]):
                ref_score[c] = float(sc[p])
        faults = ref_sel.judge(out.selections[i], ref_score, kept, th, nm,
                               config["matches_per_round"], tol)
        if faults:
            print(f"[check] group round {i}: {faults}", file=sys.stderr)
        r["selection_faults"] += len(faults)
    return r


def control_output(world, config: dict, hp, grp: Group, cast) -> Output:
    """The reference in the program's place, its index cast (the control):
    its own fitted rounds, banded scores and selections."""
    avg, counts, fits = reference_fits(world, config, hp, grp, cast)
    out = Output([], [], [], [], [])
    ids = world.clip_ids
    nm = config["near_miss_default"]
    for i, (w, th, _sim, _y) in enumerate(fits):
        sc = ref.scores(avg[i], counts[i], [1.0, w])[:len(ids)].cpu().numpy()
        lower = th - nm * (1.0 - th)
        spec = round_spec(grp, i, {}, th, nm)
        band = np.flatnonzero(sc >= lower - BAND_MARGIN)
        keep = [(c - 3) // 10 for c in spec["keep_ids"]]
        pos = sorted(set(band.tolist()) | {p for p in keep if np.isfinite(sc[p])})
        scores = {int(ids[p]): float(sc[p]) for p in pos}
        sel = ref_sel.select(scores, grp.user_matches[i], grp.ref_ids[i], th,
                             config["matches_per_round"], nm,
                             rng=random.Random(grp.select_seeds[i]))
        out.weights.append(w)
        out.thresholds.append(th)
        out.near_miss.append(nm)
        out.scores.append(scores)
        out.selections.append(list(sel))
    return out
