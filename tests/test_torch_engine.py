"""The port's SearchEngine against the JAX package's, on a 160-clip world
built like tests/test_batch_serving.py's (clips fanned out on a cone around
one direction, so scores spread over the match and near-miss bands).

f32 paths: the two packages' similarities agree to rtol 1e-5 / atol 1e-6
(CPU products summed in different orders), counts exactly, and the selected
clips are the same. Within the port, the resident banded round, the group
round and the batched similarity are bit-identical to the full-table or
solo path. Exact mode (host float64) is bit-identical to the JAX package.
"""

import copy
import math
import random

import numpy as np
import pytest
import torch

from videoquery.index.store import FeatureIndex as JaxIndex
from videoquery.index.store import FeatureRecord as JaxRecord
from videoquery.search.engine import SearchEngine as JaxEngine
from videoquery_torch.core.config import HyperParams, compute_eps
from videoquery_torch.index.records import FeatureRecord
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.search import engine as engine_mod
from videoquery_torch.search.engine import (ResidentTable, SearchEngine, _banded_args,
                                            _banded_core, _unpack_banded,
                                            optimize_many, round_scores_many)
from videoquery_torch.search.selection import (finalize_near_miss,
                                               lowest_scoring_user_match,
                                               select_clips_to_review)

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

STREAMS = ("rgb", "warped_optical_flow")
N_CLIPS, DIM = 160, 24
RTOL, ATOL = 1e-5, 1e-6


def _cone(rng, u, theta):
    w = rng.standard_normal(u.shape[0])
    w -= w @ u * u
    w /= np.linalg.norm(w)
    return np.cos(theta) * u + np.sin(theta) * w


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    u = rng.standard_normal(DIM)
    u /= np.linalg.norm(u)
    thetas = np.linspace(0.0, 1.3, N_CLIPS)
    rows = []
    for i in range(N_CLIPS):
        for s in STREAMS:
            for k in (1, 2, 3):
                if s == STREAMS[1] and k == 2 and i % 7 == 3:
                    continue  # a missing split: averaged over the other two
                if s == STREAMS[0] and i % 23 == 5:
                    continue  # a missing stream: never scored
                rows.append((10 * i + 3, s, k,
                             _cone(rng, u, thetas[i] + 0.03 * rng.standard_normal())))
    targets = [{s: {k: _cone(rng, u, 0.05 * (q + 1)) for k in (1, 2, 3)
                    if not (q == 2 and k == 3)} for s in STREAMS}
               for q in range(6)]
    jax_index = JaxIndex.build([JaxRecord(*r[:3], "global_pool", r[3]) for r in rows],
                               STREAMS, pad_multiple=512, keep_host=True)
    index = FeatureIndex.build([FeatureRecord(*r[:3], "global_pool", r[3]) for r in rows],
                               STREAMS, pad_multiple=512, keep_host=True, device="cpu")
    ids = [int(c) for c in index.clip_ids]
    return jax_index, index, targets, ids


def _labels(ids, seed, m=14):
    rng = np.random.default_rng(seed)
    return {int(c): float(rng.integers(0, 2))
            for c in rng.choice(ids[:60], m, replace=False)}


def test_full_table_matches_jax(world):
    jax_index, index, targets, ids = world
    want = JaxEngine(jax_index).compute_similarities_multi(targets)
    got = SearchEngine(index).compute_similarities_multi(targets)
    hp = HyperParams()
    for qi, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.counts, w.counts)
        np.testing.assert_allclose(g.avg_sim, w.avg_sim, rtol=RTOL, atol=ATOL)
        hp_w, grid_w = w.optimize(_labels(ids, qi), hp)
        hp_g, grid_g = g.optimize(_labels(ids, qi), hp)
        assert grid_g.grid_index == grid_w.grid_index
        assert math.isclose(hp_g.threshold, hp_w.threshold, rel_tol=1e-6)
        assert math.isclose(hp_g.weights[STREAMS[1]], hp_w.weights[STREAMS[1]],
                            rel_tol=1e-6)
        sw, sg = w.scores(hp_w.weights), g.scores(hp_g.weights)
        assert list(sg) == list(sw)
        np.testing.assert_allclose(list(sg.values()), list(sw.values()), rtol=1e-6)
        pick = [select_clips_to_review(s, {}, ids[0], hp_w.threshold, 10,
                                       hp.near_miss_default, rng=random.Random(qi))
                for s in (sw, sg)]
        assert pick[0] == pick[1] and pick[0]


@pytest.mark.parametrize("flavor", ["new", "revise", "finalize"])
def test_resident_round_matches_full_table(world, flavor):
    """Banded candidates: every value is the full table's float64 score
    bit for bit, and selection picks the same clips (new, revise and
    finalize flavors); the JAX package's resident round picks them too."""
    jax_index, index, targets, ids = world
    engine, jax_engine = SearchEngine(index), JaxEngine(jax_index)
    hp = HyperParams()
    full = engine.compute_similarities(targets[0])
    resident = engine.compute_similarities_resident(targets[0])
    jax_resident = jax_engine.compute_similarities_resident(targets[0])
    hp_r = (hp.reset_round_state() if flavor == "new"
            else resident.optimize(_labels(ids, 1), hp)[0])
    assert flavor == "new" or hp_r == full.optimize(_labels(ids, 1), hp)[0]
    scores = full.scores(hp_r.weights)
    ranked = sorted(scores, key=scores.get, reverse=True)
    user_matches, um_ids, nm, max_n = {}, [], hp.near_miss_default, 10
    if flavor == "finalize":
        user_matches = {str(ranked[2]): True, str(ranked[9]): True,
                        str(ranked[4]): False}
        um_ids = [ranked[2], ranked[9]]
        low, _ = lowest_scoring_user_match(scores, user_matches)
        nm, max_n = finalize_near_miss(hp_r.threshold, low, compute_eps()), math.inf
    args = (hp_r.weights, hp_r.threshold, hp.near_miss_default,
            [ids[0]] + um_ids, um_ids)
    red = resident.round_scores(*args, finalize=flavor == "finalize")
    jax_red = jax_resident.round_scores(*args, finalize=flavor == "finalize")
    assert red is not None and list(red) == sorted(red)
    for cid, sc in red.items():
        assert sc == scores[cid]
    lower = hp_r.threshold - nm * (1.0 - hp_r.threshold)
    assert {c for c, s in scores.items() if s >= lower} <= set(red)
    picks = [select_clips_to_review(s, user_matches, ids[0], hp_r.threshold, max_n,
                                    nm, rng=random.Random(3))
             for s in (scores, red, jax_red)]
    assert picks[0] and picks[0] == picks[1] == picks[2]


def _specs(tables, hp, ids, threshold=None):
    out = []
    for qi, t in enumerate(tables):
        h = t.optimize(_labels(ids, qi), hp)[0]
        out.append({"weights": h.weights,
                    "threshold": h.threshold if threshold is None else threshold,
                    "near_miss": hp.near_miss_default, "keep_ids": [ids[qi]],
                    "user_match_ids": [ids[10]] if qi % 2 else [],
                    "finalize": qi % 2 == 1})
    return out


def test_group_round_bit_identical_to_solo(world):
    _, index, targets, ids = world
    engine, hp = SearchEngine(index), HyperParams()
    tables = engine.compute_similarities_multi(targets, resident=True)
    solo = [engine.compute_similarities_resident(t) for t in targets]
    labels = [_labels(ids, qi) for qi in range(len(targets))]
    many = optimize_many(tables, labels, hp)
    for (h_m, g_m), t, lab in zip(many, solo, labels):
        h_s, g_s = t.optimize(lab, hp)
        assert h_m == h_s
        np.testing.assert_array_equal(g_m.losses, g_s.losses)
    specs = _specs(solo, hp, ids)
    got = round_scores_many(tables, specs)
    for g, t, r in zip(got, solo, specs):
        want = t.round_scores(r["weights"], r["threshold"], r["near_miss"],
                              r["keep_ids"], r["user_match_ids"],
                              finalize=r["finalize"])
        assert g is not None and g == want


@pytest.mark.parametrize("overflow", ["every_row", "some_rows"])
def test_group_cap_overflow_escalates_then_falls_through(world, monkeypatch, overflow):
    """The rows whose band is wider than a cap retry together at the next
    cap and equal their calls alone; a row that fits is not computed again
    (a spy on _band_rows). Wider than every cap gives None, and the
    full-table fallback is exact."""
    _, index, targets, ids = world
    engine, hp = SearchEngine(index), HyperParams()
    tables = engine.compute_similarities_multi(targets[:3], resident=True)
    specs = _specs(tables, hp, ids)
    if overflow == "every_row":
        wide, cap0 = [0, 1, 2], 4
        for i in wide:
            specs[i] = {**specs[i], "threshold": -10.0}  # the band is everything
    else:
        wide = [2]  # the second row of its flavor
        # the narrow rows' bands fit the first cap (a band is at most its dict)
        cap0 = max(len(tables[i].round_scores(**specs[i], caps=(512,))) for i in (0, 1))
        scores2 = tables[2].to_table().scores(specs[2]["weights"])
        ranked = sorted(scores2, key=scores2.get, reverse=True)
        assert cap0 + 16 < len(ranked)
        # row 2: a band wider than the first cap but not everything, and a
        # second kept clip, the lowest-scoring one, outside it
        specs[2] = {**specs[2], "threshold": scores2[ranked[cap0 + 8]], "near_miss": 0.0,
                    "keep_ids": [ids[2], ranked[-1]]}
    solo = [t.round_scores(**r, caps=(512,)) for t, r in zip(tables, specs)]
    assert all(len(solo[i]) > cap0 + 4 for i in wide)
    calls = []
    band_rows = engine_mod._band_rows

    def spy(index, group, avg, counts, w, threshold, *rest):
        calls.append((rest[-2], list(threshold), rest[-1]))  # finalize, rows, cap
        return band_rows(index, group, avg, counts, w, threshold, *rest)

    monkeypatch.setattr(engine_mod, "_band_rows", spy)
    escalated = round_scores_many(tables, specs, caps=(cap0, 512))
    want_calls = []
    for finalize, rows in ((False, [0, 2]), (True, [1])):  # _specs' flavors
        want_calls.append((finalize, [specs[i]["threshold"] for i in rows], cap0))
        if retry := [i for i in rows if i in wide]:
            want_calls.append((finalize, [specs[i]["threshold"] for i in retry], 512))
    assert calls == want_calls
    monkeypatch.undo()
    for i, (g, t, r) in enumerate(zip(escalated, tables, specs)):
        assert g is not None and g == solo[i]
        assert g == t.round_scores(**r, caps=(cap0, 512))
        if i in wide and overflow == "every_row":
            assert len(g) == len(t.to_table().scores(r["weights"]))
    if overflow == "some_rows":
        assert ranked[-1] in escalated[2]
    fell = round_scores_many(tables, specs, caps=(cap0, cap0 + 4))
    assert [g is None for g in fell] == [i in wide for i in range(3)]
    assert all(g == solo[i] for i, g in enumerate(fell) if i not in wide)
    full = engine.compute_similarities(targets[0])
    back = tables[0].to_table()
    np.testing.assert_array_equal(back.avg_sim, full.avg_sim)
    np.testing.assert_array_equal(back.counts, full.counts)


def test_a_group_over_two_indexes_is_refused(world):
    """A group's rows map their positions to clip ids through one index:
    tables over two index objects, or over one index in two groups, raise
    in both group functions instead of scoring the wrong clips."""
    _, index, targets, ids = world
    engine, hp = SearchEngine(index), HyperParams()
    a, b = engine.compute_similarities_multi(targets[:2], resident=True)
    specs = _specs([a, b], hp, ids)
    other = ResidentTable(copy.copy(index), b.avg, b.counts)
    regrouped = ResidentTable(index, b.avg, b.counts, group=object())
    for mixed in ([a, other], [a, regrouped]):
        with pytest.raises(ValueError, match="one index and one group"):
            optimize_many(mixed, [_labels(ids, 0), _labels(ids, 1)], hp)
        with pytest.raises(ValueError, match="one index and one group"):
            round_scores_many(mixed, specs)


def _packed_row(resident, weights, threshold, keep_ids, cap):
    """One packed row of _banded_core for a revise round with near miss 0
    (the band: scores >= threshold), as the card downloads it (f32)."""
    w, keep_pos, n_keep, _, _ = _banded_args(resident.index, [{
        "weights": weights, "keep_ids": keep_ids, "user_match_ids": []}])
    f32 = dict(dtype=torch.float32)
    row = _banded_core(resident.avg[None], resident.counts[None],
                       torch.tensor(w, **f32), torch.tensor([threshold], **f32),
                       torch.zeros(1, **f32), compute_eps(),
                       torch.from_numpy(keep_pos), None, cap)[0].numpy()
    return row, w[0], keep_pos[0], n_keep[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["kept_in_band", "empty_band", "band_fills_cap",
                                  "band_overflows_cap"])
def test_band_decode_is_the_full_tables_scores(world, case, dtype):
    """_unpack_banded reads only the live prefix of a packed row: its dict is
    the full table's float64 scores of the band and the valid kept clips,
    the same keys in the same ascending order, each value equal; a band one
    wider than the cap gives None. The row as downloaded (f32) and widened
    to f64 (merge_banded's rows) decode alike."""
    _, index, targets, ids = world
    engine = SearchEngine(index)
    weights = {STREAMS[0]: 1.0, STREAMS[1]: 0.7}
    scores = engine.compute_similarities(targets[1]).scores(weights)
    resident = engine.compute_similarities_resident(targets[1])
    ranked = sorted(scores, key=scores.get, reverse=True)
    best = sorted(scores.values(), reverse=True)
    # a band of k clips, its bound in the widest gap near 40 so f32 and the
    # device margin cannot move a clip across it
    k = max(range(36, 46), key=lambda j: best[j - 1] - best[j])
    assert best[k - 1] - best[k] > 1e-4
    threshold, cap, band = (best[k - 1] + best[k]) / 2, 64, set(ranked[:k])
    invalid = 53                      # its rgb stream is missing (i % 23 == 5)
    assert invalid in ids and invalid not in scores
    keep = [ranked[3], ranked[k + 5], invalid]       # in the band, out, invalid
    if case == "empty_band":
        threshold, band = 2.0, set()
    elif case == "band_fills_cap":
        cap = k
    elif case == "band_overflows_cap":
        cap = k - 1
    row, w, keep_pos, n_keep = _packed_row(resident, weights, threshold, keep, cap)
    assert int(row[-1]) == len(band)
    got = _unpack_banded(index, row.astype(dtype), w, keep_pos, n_keep, cap)
    if case == "band_overflows_cap":
        assert got is None
        return
    want = {c: v for c, v in scores.items() if c in band or c in keep}
    assert list(got) == list(want) and len(want) == len(band | set(keep[:2]))
    for c, v in want.items():
        assert got[c] == v


def test_batched_similarity_bit_identical_to_solo(world):
    _, index, targets, _ = world
    engine = SearchEngine(index)
    batch = engine.compute_similarities_multi(targets)
    for t, b in zip(targets, batch):
        solo = engine.compute_similarities(t)
        np.testing.assert_array_equal(b.avg_sim, solo.avg_sim)
        np.testing.assert_array_equal(b.counts, solo.counts)


def test_exact_mode_bitwise_matches_jax(world):
    jax_index, index, targets, ids = world
    hp = HyperParams()
    for qi, target in enumerate(targets[:3]):
        want = JaxEngine(jax_index, exact=True).compute_similarities(target)
        got = SearchEngine(index, exact=True).compute_similarities(target)
        np.testing.assert_array_equal(got.avg_sim, want.avg_sim)
        np.testing.assert_array_equal(got.counts, want.counts)
        hp_w, grid_w = want.optimize(_labels(ids, qi), hp)
        hp_g, grid_g = got.optimize(_labels(ids, qi), hp)
        assert hp_g == hp_w
        np.testing.assert_array_equal(grid_g.losses, grid_w.losses)
        assert got.scores(hp_g.weights) == want.scores(hp_w.weights)
    with pytest.raises(ValueError):
        SearchEngine(index, exact=True).compute_similarities_multi(targets)
