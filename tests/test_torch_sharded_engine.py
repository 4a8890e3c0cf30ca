"""The port's SearchEngine over an index sharded along the "data" axis.

The world is the cone world of tests/test_torch_engine.py
(``videoquery_torch.testing.sharded_serving.cone_world``: 160 clips of
24-d features, 2 streams x 3 splits, one clip in 7 missing a flow split,
one in 23 its rgb stream, angles dealt to positions at random so a round's
band holds clips on every shard), padded to 160.

- In-process shards (R = 2 and 4, ``InProcessShards``): each shard's K1
  (its plain version here), the tables concatenated, the rounds merged by
  ``merge_banded``. Held against the port's unsharded engine: counts, clip
  ids and selections equal; similarities and scores within
  ``sharded_serving.CPU_TOL`` (2e-6: host BLAS may sum a shard's products
  in another order than the whole index's; measured equal at this size).
  The same shards cut from the unsharded engine's own tables ("sliced")
  must give its rounds bit for bit: the merge moves bits, it computes
  nothing.
- The JAX engine on ``index.shard(NamedSharding(mesh, P(None, None,
  DATA_AXIS, None)))`` over conftest's 8 virtual devices, as the JAX dry
  run's step 3b: tables within rtol 1e-5 / atol 1e-6, counts equal, the
  same selections and grid cell.
- ``SearchEngine(index, mesh=mesh)`` on a Gloo world of one rank in this
  process (the sharded code on groups of one): every call equal to the
  unsharded engine's bit for bit, the group paths to the solo ones.
- ``python -m videoquery_torch.tools.dryrun --world 2 --device cpu``: two
  spawned Gloo ranks, its five steps, exit 0.
"""

import math
import os
import random
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from videoquery.core.meshes import DATA_AXIS as JAX_DATA_AXIS
from videoquery.core.meshes import make_mesh as jax_make_mesh
from videoquery.index.store import FeatureIndex as JaxIndex
from videoquery.search.engine import SearchEngine as JaxEngine
from videoquery_torch.core.config import HyperParams, compute_eps
from videoquery_torch.core.meshes import initialize_multihost, make_mesh
from videoquery_torch.index.store import ShardSpec
from videoquery_torch.search.engine import (SearchEngine, _banded_args, _local_rows,
                                            _unpack_banded, merge_banded, optimize_many,
                                            round_scores_many)
from videoquery_torch.search.selection import (finalize_near_miss,
                                               lowest_scoring_user_match,
                                               select_clips_to_review)
from videoquery_torch.testing.sharded_serving import (CPU_TOL, InProcessShards,
                                                      cone_world)

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_CLIPS, DIM, N_QUERIES = 160, 24, 6
QUARTER = N_CLIPS // 4
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def world():
    w = cone_world(N_CLIPS, DIM, N_QUERIES, device="cpu", pad_multiple=32)
    assert w.index.n_padded == N_CLIPS
    return w


@pytest.fixture(scope="module")
def unsharded(world):
    engine = SearchEngine(world.index)
    return (engine.compute_similarities_multi(world.targets),
            engine.compute_similarities_multi(world.targets, resident=True))


@pytest.fixture(scope="module")
def jax_engine(world):
    import jax.numpy as jnp

    idx = world.index
    jax_index = JaxIndex(idx.clip_ids, jnp.asarray(idx.feats.numpy()),
                         jnp.asarray(idx.mask.numpy()), idx.streams, idx.splits,
                         idx.feature_name)
    return JaxEngine(jax_index.shard(
        NamedSharding(jax_make_mesh(), P(None, None, JAX_DATA_AXIS, None))))


def shards(world, unsharded, n_shards, source):
    """R in-process shards: each scored by K1 ("k1") or cut from the
    unsharded engine's resident tables ("sliced")."""
    if source == "k1":
        return InProcessShards.from_index(world.index, world.targets, n_shards)
    avg = torch.stack([t.avg for t in unsharded[1]])        # [Q, S, N]
    counts = torch.stack([t.counts for t in unsharded[1]])
    n = N_CLIPS // n_shards
    return InProcessShards(world.index, [avg[:, :, r * n:(r + 1) * n] for r in range(n_shards)],
                           [counts[:, :, r * n:(r + 1) * n] for r in range(n_shards)])


def ids_by_angle(world, quarter):
    """The scored clips of a quarter of the clip axis, nearest the axis
    first (a clip missing its rgb stream is never scored)."""
    pos = [p for p in np.argsort(world.thetas, kind="stable")
           if p // QUARTER == quarter and p % 23 != 5]
    return [int(world.index.clip_ids[p]) for p in pos]


def fitted_hp(world, unsharded, qi):
    """The analyst's round on query qi, fitted by the unsharded engine:
    the 3 clips nearest the axis in each quarter match, the 20th-22nd not."""
    labels = {}
    for quarter in range(4):
        near = ids_by_angle(world, quarter)
        labels.update({c: 1.0 for c in near[:3]})
        labels.update({c: 0.0 for c in near[20:23]})
    return unsharded[1][qi].optimize(labels, HyperParams())[0], labels


def case_spec(world, unsharded, case):
    """(query, round kwargs, reference clip) of a round case."""
    near = [ids_by_angle(world, quarter) for quarter in range(4)]
    missing = [int(world.index.clip_ids[p]) for p in range(N_CLIPS) if p % 23 == 5]
    qi = {"revise": 0, "finalize": 1, "missing_stream": 2, "keep_every_shard": 3}[case]
    hp, _ = fitted_hp(world, unsharded, qi)
    spec = dict(weights=hp.weights, threshold=hp.threshold,
                near_miss=HyperParams().near_miss_default, keep_ids=[near[0][-1]],
                user_match_ids=[], finalize=False)
    if case == "finalize":
        # the lowest user match lies in the last quarter and scores below the
        # threshold, the other in the first
        um = [near[0][0], near[3][25]]
        spec.update(keep_ids=[near[0][-1]] + um, user_match_ids=um, finalize=True)
    elif case == "keep_every_shard":
        spec.update(keep_ids=[n[-1] for n in near] + [n[-2] for n in near])
    elif case == "missing_stream":
        # a kept and user-matched clip without its rgb stream is never
        # scored; the other user match sets the band
        spec.update(keep_ids=[missing[1], near[1][-1]],
                    user_match_ids=[missing[1], near[2][20]], finalize=True)
    return qi, spec, near[0][-1]


def select(scores, spec, ref):
    user_matches, nm, max_n = {}, spec["near_miss"], 10
    if spec["finalize"]:
        user_matches = {str(c): True for c in spec["user_match_ids"]}
        low, _ = lowest_scoring_user_match(scores, user_matches)
        nm, max_n = finalize_near_miss(spec["threshold"], low, compute_eps()), math.inf
    return select_clips_to_review(scores, user_matches, ref, spec["threshold"], max_n, nm,
                                  rng=random.Random(3))


def assert_same_round(got, want, exact):
    assert got is not None and want is not None
    assert list(got) == list(want)
    if exact:
        assert got == want
    else:
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   rtol=CPU_TOL, atol=CPU_TOL)


SOURCES = ["k1", "sliced"]
CASES = ["revise", "finalize", "keep_every_shard", "missing_stream"]


@pytest.fixture(scope="module")
def jax_rounds(world, unsharded, jax_engine):
    """The JAX engine's resident round of every case on the sharded index."""
    out = {}
    for case in CASES:
        qi, spec, _ = case_spec(world, unsharded, case)
        table = jax_engine.compute_similarities_resident(world.targets[qi])
        out[case] = table.round_scores(spec["weights"], spec["threshold"],
                                       spec["near_miss"], spec["keep_ids"],
                                       spec["user_match_ids"], finalize=spec["finalize"])
    return out


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("n_shards", [2, 4])
def test_table(world, unsharded, jax_engine, n_shards, source):
    """The concatenated shard tables: the unsharded engine's and the JAX
    engine's on the data-sharded index."""
    sh = shards(world, unsharded, n_shards, source)
    want = jax_engine.compute_similarities_multi(world.targets)
    for qi, (table, jt) in enumerate(zip(unsharded[0], want)):
        avg, counts = sh.table(qi)
        np.testing.assert_array_equal(counts, table.counts)
        np.testing.assert_array_equal(counts, jt.counts)
        if source == "sliced":
            np.testing.assert_array_equal(avg, table.avg_sim)
        np.testing.assert_allclose(avg, table.avg_sim, rtol=CPU_TOL, atol=CPU_TOL)
        np.testing.assert_allclose(avg, jt.avg_sim, rtol=JAX_RTOL, atol=JAX_ATOL)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_round(world, unsharded, jax_rounds, case, n_shards, source):
    """A resident round over R shards, merged: the unsharded engine's dict
    (bit for bit from the sliced tables) and selection, and the JAX
    engine's selection on the data-sharded index."""
    qi, spec, ref = case_spec(world, unsharded, case)
    sh = shards(world, unsharded, n_shards, source)
    got = sh.round_scores(qi, **spec)
    want = unsharded[1][qi].round_scores(**spec)
    assert_same_round(got, want, exact=source == "sliced")
    scores = unsharded[0][qi].scores(spec["weights"])
    owners = {c: world.index.position(c) // (N_CLIPS // n_shards) for c in got}
    assert len(set(owners.values())) == n_shards, "the band misses a shard"
    for c in spec["keep_ids"]:
        assert (c in got) == (c in scores)
        if c in got and source == "sliced":
            assert got[c] == scores[c]
    if case == "finalize":
        um = spec["user_match_ids"]
        low_um = min(um, key=scores.get)
        lowest = min((c for c in got if c not in um), key=got.get)
        assert owners[low_um] != owners[lowest]
        assert scores[low_um] < spec["threshold"] < scores[um[0]]
    if case == "missing_stream":
        assert spec["user_match_ids"][0] not in got
        assert scores[spec["user_match_ids"][1]] < spec["threshold"]
    picks = [list(select(s, spec, ref)) for s in (got, want, jax_rounds[case])]
    assert picks[0] and picks[0] == picks[1] == picks[2]


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("n_shards", [2, 4])
def test_cap_overflows_globally_not_on_a_shard(world, unsharded, n_shards, source):
    """A band wider than the cap in all but narrower on every shard: no
    shard overflows, the merged row does (None, as unsharded), and the next
    cap gives the unsharded dict."""
    qi, spec, _ = case_spec(world, unsharded, "revise")
    spec = {**spec, "threshold": spec["threshold"] - 0.1}
    sh = shards(world, unsharded, n_shards, source)
    w, keep_pos, _, um_pos, um_mask = (a[0] for a in _banded_args(sh.index, [spec]))
    per_shard = sh.band_rows(qi, w, spec["threshold"], spec["near_miss"], keep_pos,
                             um_pos, um_mask, False, 512)[:, -1]
    cap = int(per_shard.max())
    assert 0 < cap < per_shard.sum()
    args = {k: v for k, v in spec.items()}
    assert sh.round_scores(qi, **args, caps=(cap,)) is None
    assert unsharded[1][qi].round_scores(**args, caps=(cap,)) is None
    got = sh.round_scores(qi, **args, caps=(cap, 512))
    want = unsharded[1][qi].round_scores(**args, caps=(cap, 512))
    assert_same_round(got, want, exact=source == "sliced")
    assert len(got) > cap


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("n_shards", [2, 4])
def test_optimize_reviewed_on_every_shard(world, unsharded, jax_engine, n_shards, source):
    """The optimizer over reviewed clips on every shard: the unsharded
    engine's result (bit for bit from the sliced tables); the JAX engine's
    grid cell on the data-sharded index."""
    hp = HyperParams()
    sh = shards(world, unsharded, n_shards, source)
    for qi in (0, 4):
        _, labels = fitted_hp(world, unsharded, qi)
        owners = {world.index.position(c) // (N_CLIPS // n_shards) for c in labels}
        assert owners == set(range(n_shards))
        h_got, g_got = sh.optimize(qi, labels, hp)
        h_want, g_want = unsharded[1][qi].optimize(labels, hp)
        h_jax, g_jax = jax_engine.compute_similarities_resident(
            world.targets[qi]).optimize(labels, hp)
        assert g_got.grid_index == g_want.grid_index == g_jax.grid_index
        if source == "sliced":
            assert h_got == h_want
            np.testing.assert_array_equal(g_got.losses, g_want.losses)
        assert math.isclose(h_got.threshold, h_want.threshold, rel_tol=1e-6)
        assert math.isclose(h_got.threshold, h_jax.threshold, rel_tol=1e-6)


def test_merge_keeps_rank_order_and_sums_the_band():
    """merge_banded on hand-made rows of 2 shards, S = 1, cap 4, 2 kept
    slots: positions offset by rank * n_local in rank order, the kept slots
    from their owners, n_in_band summed; -0.0 kept as -0.0."""
    s, cap, n_local = 1, 4, 10
    r0 = [0.5, -0.0, 0, 0] + [1, 1, 0, 0] + [2, 7, -1, -1] + [0.1, 0.2] + [1, 0] + [2]
    r1 = [0.7, 0, 0, 0] + [1, 0, 0, 0] + [3, -1, -1, -1] + [0.3, 0.4] + [0, 1] + [1]
    out = merge_banded(np.asarray([r0, r1], np.float64), s, cap, n_local,
                       np.asarray([0, 1]))
    cand = out[:(s + 2) * cap].reshape(s + 2, cap)
    np.testing.assert_array_equal(cand[2], [2, 7, 13, -1])
    np.testing.assert_array_equal(cand[0, :3], [0.5, -0.0, 0.7])
    assert np.signbit(cand[0, 1])
    np.testing.assert_array_equal(cand[1, :3], [1, 1, 1])
    np.testing.assert_array_equal(out[(s + 2) * cap:-1].reshape(s + 1, 2), [[0.1, 0.4], [1, 1]])
    assert out[-1] == 3


class _Ids:
    """Clip ids of an index too long to hold: id = 10 * position + 3."""

    def __getitem__(self, pos):
        return np.asarray(pos, np.int64) * 10 + 3


def test_merged_row_decodes_positions_past_2_24():
    """Two shards of 2^24 + 1 positions each: rank 1's global positions pass
    2^24, where f32 holds only even integers. The merged f64 row decodes to
    the exact positions, with the float64 scores of the shards' similarities;
    a kept clip on each rank and an invalid one on rank 1."""
    s, n, cap, n_local = 2, 12, 32, 2**24 + 1
    rng = np.random.default_rng(5)
    avg = torch.from_numpy(rng.uniform(0.3, 1.0, (2, s, n)).astype(np.float32))
    counts = torch.ones(2, s, n, dtype=torch.int32)
    counts[1, 0, 3] = 0                                   # global n_local + 3
    w = np.asarray([1.0, 0.7])
    keep_pos = np.asarray([2, n_local + 5, n_local + 3, 0])   # padded to 4
    f32 = dict(dtype=torch.float32)
    rows = np.stack([
        _local_rows(avg[r][None], counts[r][None], torch.tensor(w[None], **f32),
                    torch.tensor([-1.0], **f32), torch.zeros(1, **f32),  # every valid clip
                    keep_pos[None], None, cap, ShardSpec(r, 2, n_local))[0].numpy()
        for r in range(2)]).astype(np.float64)
    merged = merge_banded(rows, s, cap, n_local, ShardSpec(0, 2, n_local).locate(keep_pos)[0])
    index = SimpleNamespace(streams=("rgb", "flow"), shard_spec=None, clip_ids=_Ids())
    got = _unpack_banded(index, merged, w, keep_pos, 3, cap)

    a = torch.cat([avg[0], avg[1]], dim=1).numpy().astype(np.float64)  # [S, 2n]
    dev = w[:, None] * (1.0 - a)
    sc = 1.0 - np.sqrt((dev * dev).sum(axis=0) / (w * w).sum())
    pos = np.concatenate([np.arange(n), n_local + np.arange(n)])
    valid = (torch.cat([counts[0], counts[1]], dim=1) > 0).all(dim=0).numpy()
    want = dict(zip((10 * pos[valid] + 3).tolist(), sc[valid].tolist()))
    assert any(float(np.float32(p)) != p for p in pos[valid])
    assert list(got) == list(want) and len(want) == 2 * n - 1
    for c, v in want.items():
        assert got[c] == v


# -- SearchEngine(index, mesh=...) on a Gloo world of one rank -----------------

@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("dist") / "store"
    initialize_multihost(f"file://{store}", 1, 0, "cpu")
    try:
        yield make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_engine_equals_unsharded_and_group_equals_solo(world, unsharded, mesh):
    """Every call of the mesh engine against the unsharded engine's, bit for
    bit; optimize_many and round_scores_many (with the cap escalation)
    against the solo calls; to_table against the table flavor."""
    hp = HyperParams()
    engine = SearchEngine(world.index, mesh=mesh)
    assert engine.index.shard_spec == (0, 1, N_CLIPS)
    assert engine.index.feats.data_ptr() == world.index.feats.data_ptr()
    tables = engine.compute_similarities_multi(world.targets)
    resident = engine.compute_similarities_multi(world.targets, resident=True)
    for t, u in zip(tables, unsharded[0]):
        np.testing.assert_array_equal(t.avg_sim, u.avg_sim)
        np.testing.assert_array_equal(t.counts, u.counts)
    back = resident[0].to_table()
    np.testing.assert_array_equal(back.avg_sim, tables[0].avg_sim)
    labels = [fitted_hp(world, unsharded, qi)[1] for qi in range(N_QUERIES)]
    many = optimize_many(resident, labels, hp)
    for (h_m, g_m), t, u, lab in zip(many, resident, unsharded[1], labels):
        h_s, g_s = t.optimize(lab, hp)
        h_u, g_u = u.optimize(lab, hp)
        assert h_m == h_s == h_u
        np.testing.assert_array_equal(g_m.losses, g_u.losses)
    specs = []
    for case in CASES:
        qi, spec, _ = case_spec(world, unsharded, case)
        specs.append((qi, spec))
    rounds = [dict(spec) for _, spec in specs]
    group = [resident[qi] for qi, _ in specs]
    for caps in [(32_768,), (16, 512)]:
        got = round_scores_many(group, rounds, caps=caps)
        for g, (qi, spec) in zip(got, specs):
            assert g is not None
            assert g == resident[qi].round_scores(**spec, caps=caps)
            assert g == unsharded[1][qi].round_scores(**spec, caps=caps)


def test_a_shard_without_a_mesh_is_refused(world, mesh):
    """SearchEngine(shard) used to give a partial table and IndexErrors;
    it raises ValueError naming the mesh argument. exact mode takes no
    mesh, and a shard is not sharded again."""
    shard = world.index.shard(0, 2, "cpu")
    with pytest.raises(ValueError, match="mesh="):
        SearchEngine(shard)
    with pytest.raises(ValueError, match="exact"):
        SearchEngine(world.index, exact=True, mesh=mesh)
    with pytest.raises(ValueError, match="already shard"):
        shard.shard(0, 2, "cpu")
    owner, local = shard.shard_spec.locate([0, 79, 80, 159])
    np.testing.assert_array_equal(owner, [0, 0, 1, 1])
    np.testing.assert_array_equal(local, [0, 79, 0, 79])
    assert shard.position(world.index.clip_ids[100]) == 100


def test_dryrun_on_two_cpu_ranks(tmp_path):
    """The dry run's five steps on two spawned Gloo ranks (step 3 reports
    that it needs 6), each a [dryrun] line, then OK and exit 0."""
    env = dict(os.environ, OMP_NUM_THREADS="2", TMPDIR=str(tmp_path))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "videoquery_torch.tools.dryrun",
                        "--world", "2", "--device", "cpu"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[dryrun]")]
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert len(lines) == 6 and lines[-1].startswith("[dryrun] OK on 2 ranks"), lines
    for key in ("train step", "sharded extraction", "6-member ensemble",
                "sharded search top-5", "batched serving program"):
        assert sum(key in ln for ln in lines) == 1, (key, lines)
