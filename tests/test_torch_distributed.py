"""The port's scale-out search path (videoquery_torch.search.distributed,
index.store's shard and target_arrays, search.scoring's single-target
functions, service.compute_matches.process_job) against the JAX package.

- ShardedSearch in a 1-rank Gloo world (a ``file://`` store under the
  test's temporary directory: tier-1 runs 6 workers at once) against the
  JAX ShardedSearch on conftest's 8 virtual devices, on the world of
  tests/test_distributed.py: id sets equal, scores at rtol 1e-4 / atol 1e-5
  (that test's tolerance).
- R = 1, 2, 4 row shards, each scored alone and merged, against the
  unsharded top-k.
- target_arrays bitwise; ensemble_similarities, weighted_scores and
  score_weight_grid at rtol 1e-5 / atol 1e-6.
- process_job on the fixture CSVs, new -> revise -> finalize, against the
  JAX process_job on the f32 path: the same selection.
"""

import importlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_distributed import STREAMS, build_index
from test_batch_serving import snapshot
from test_torch_broker import SEED, fixture_lifecycle
from videoquery.core.config import HyperParams as JaxHyperParams
from videoquery.core.meshes import make_mesh as jax_make_mesh
from videoquery.search import scoring as jax_scoring
from videoquery.search.distributed import ShardedSearch as JaxShardedSearch
from videoquery.service.repository import APIRepository as JaxRepository
from videoquery.testing.fake_api import FakeClient
from videoquery_torch.core.config import HyperParams
from videoquery_torch.core.meshes import initialize_multihost, make_mesh
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.kernels.query import fused_query_topk
from videoquery_torch.search import scoring
from videoquery_torch.search.distributed import ShardedSearch, merge_topk
from videoquery_torch.service.repository import APIRepository

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

jax_cm = importlib.import_module("videoquery.service.compute_matches")
port_cm = importlib.import_module("videoquery_torch.service.compute_matches")


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A Gloo world of one rank, for this module's tests."""
    store = tmp_path_factory.mktemp("dist") / "store"
    initialize_multihost(f"file://{store}", 1, 0, "cpu")
    try:
        yield make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def port_index(jax_index):
    """The port's index over a JAX FeatureIndex's arrays."""
    return FeatureIndex.from_numpy(
        jax_index.clip_ids, np.asarray(jax_index.feats), np.asarray(jax_index.mask),
        jax_index.streams, jax_index.splits, jax_index.feature_name, device="cpu")


def world(rng, q=3, n=100, dim=32):
    index = build_index(rng, n=n, dim=dim)
    targets, weights = [], []
    for _ in range(q):
        targets.append({s: {k: rng.normal(size=dim).tolist() for k in (1, 2, 3)}
                        for s in STREAMS})
        weights.append({"rgb": 1.0, "warped_optical_flow": 1.5})
    return index, targets, weights


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_sharded_search_matches_jax(rng, mesh, impl):
    index, targets, weights = world(rng)
    want_vals, want_ids = JaxShardedSearch(index, jax_make_mesh(model_parallel=1)
                                           ).query_dicts(targets, weights, k=10)
    search = ShardedSearch(port_index(index), mesh, impl=impl)
    vals, ids = search.query_dicts(targets, weights, k=10)
    assert vals.shape == (3, 10) and ids.shape == (3, 10)
    assert vals.dtype == np.float32 and ids.dtype == np.int64
    for qi in range(3):
        np.testing.assert_allclose(vals[qi], want_vals[qi], rtol=1e-4, atol=1e-5)
        assert set(ids[qi].tolist()) == set(want_ids[qi].tolist())


def test_sharded_search_ids_beyond_the_clips_are_minus_one(rng, mesh):
    """k above the real clip count: the padding's positions come back as -1."""
    index = build_index(rng, n=5, dim=8, p_missing=0.0)      # 5 clips, 8 padded
    _, targets, weights = world(rng, q=2, n=5, dim=8)
    search = ShardedSearch(port_index(index), mesh)
    vals, ids = search.query_dicts(targets, weights, k=8)
    assert sorted(ids[0][:5].tolist()) == sorted(int(c) for c in index.clip_ids)
    assert ids[:, 5:].tolist() == [[-1] * 3] * 2
    assert (vals[:, 5:] < -1.0).all()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_merged_row_shards_equal_the_unsharded_topk(rng, n_shards):
    """Each of R row shards scored alone (its local top-k offset to global
    positions), merged by merge_topk: the unsharded top-k."""
    index, targets, weights = world(rng, q=4, n=100, dim=32)
    full = port_index(index)
    search_t = [full.target_arrays(t) for t in targets]
    t = torch.stack([a for a, _ in search_t])
    tm = torch.stack([m for _, m in search_t])
    w = torch.tensor([[1.0, 1.5]] * 4)
    want_vals, want_pos = fused_query_topk(full.feats, full.mask, t, tm, w, k=10)
    vals, pos = [], []
    for r in range(n_shards):
        shard = full.shard(r, n_shards, "cpu")
        assert shard.n_padded == full.n_padded // n_shards
        assert shard.n_clips == full.n_clips
        v, i = fused_query_topk(shard.feats, shard.mask, t, tm, w, k=10)
        vals.append(v)
        pos.append(i + r * shard.n_padded)
    got_vals, got_pos = merge_topk(torch.stack(vals), torch.stack(pos), 10)
    torch.testing.assert_close(got_vals, want_vals, rtol=1e-5, atol=1e-6)
    assert torch.equal(got_pos, want_pos)


def test_shard_requires_divisible_padding(rng):
    index = port_index(build_index(rng, n=10, dim=8, pad_multiple=3))
    assert index.n_padded == 12
    with pytest.raises(ValueError, match="not divisible"):
        index.shard(0, 5, "cpu")
    index.shard(3, 4, "cpu")


def test_target_arrays_bitwise(rng):
    index = build_index(rng, n=20, dim=16)
    target = {"rgb": {1: rng.normal(size=16).tolist(), "3": rng.normal(size=16).tolist()},
              "warped_optical_flow": {2: rng.normal(size=16)}}
    want_t, want_m = index.target_arrays(target)
    got_t, got_m = port_index(index).target_arrays(target)
    assert got_t.dtype == torch.float32 and got_m.dtype == torch.bool
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_scoring_functions_match_jax(rng):
    s, k, n, d = 2, 3, 50, 32
    cands = rng.normal(size=(s, k, n, d)).astype(np.float32)
    cmask = rng.random((s, k, n)) > 0.3
    cmask[:, :, 0] = False                       # a clip missing both streams
    cmask[1, :, 1] = False                       # a clip missing one stream
    targets = rng.normal(size=(s, k, d)).astype(np.float32)
    tmask = np.array([[True, False, True], [True, True, True]])
    want_avg, want_cnt = jax_scoring.ensemble_similarities(targets, tmask, cands, cmask)
    avg, cnt = scoring.ensemble_similarities(*map(torch.from_numpy,
                                                  (targets, tmask, cands, cmask)))
    assert avg.dtype == torch.float32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_allclose(avg.numpy(), np.asarray(want_avg), rtol=1e-5, atol=1e-6)

    weights = np.array([1.0, 1.7], np.float32)
    want_sc, want_valid = jax_scoring.weighted_scores(want_avg, want_cnt, weights)
    sc, valid = scoring.weighted_scores(avg, cnt, torch.from_numpy(weights))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert not valid[0] and not valid[1] and torch.isneginf(sc[:2]).all()
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=1e-5, atol=1e-6)

    grid = np.linspace(0.0, 3.0, 40).astype(np.float32)
    want_grid = jax_scoring.score_weight_grid(want_avg[:, 2:], grid)
    got_grid = scoring.score_weight_grid(avg[:, 2:], torch.from_numpy(grid))
    assert got_grid.shape == (40, n - 2)
    np.testing.assert_allclose(got_grid.numpy(), np.asarray(want_grid), rtol=1e-5, atol=1e-6)


def job_poll(cm, repository, hp, **kw):
    """One poll through process_job: drain every pending job, then each one
    alone, estimation to finish, with its own seeded rng."""
    def poll(api, report_dir):
        repo = repository(FakeClient(api), "fake://")
        for job in cm.drain_pending_jobs(repo, repo.client, seed=SEED,
                                         report_dir=report_dir):
            cm.process_job(job.ticket, job.update_type, job.update_object, hp,
                           rng=job.rng, **kw)
    return poll


def test_process_job_matches_jax(tmp_path):
    """The f32 path, as tests/test_torch_broker.py holds the batched
    rounds: equal states and notes, the same selection bit for bit, scores
    within rtol 1e-6."""
    want = snapshot(fixture_lifecycle(
        job_poll(jax_cm, JaxRepository, JaxHyperParams()), str(tmp_path / "jax")))
    got = snapshot(fixture_lifecycle(
        job_poll(port_cm, APIRepository, HyperParams(), device="cpu"),
        str(tmp_path / "port")))
    assert got.keys() == want.keys()
    for name in want:
        (state_w, notes_w, rounds_w, _), (state_g, notes_g, rounds_g, _) = want[name], got[name]
        assert state_g == state_w and notes_g == notes_w
        assert [r[0] for r in rounds_g] == [r[0] for r in rounds_w] == [1, 2, 3]
        for rw, rg in zip(rounds_w, rounds_g):
            # the selection, bit-equal: the same clips with the same marks
            assert [m[0] for m in rg[4]] == [m[0] for m in rw[4]] and rw[4]
            assert [m[2:] for m in rg[4]] == [m[2:] for m in rw[4]]
            np.testing.assert_allclose([m[1] for m in rg[4]], [m[1] for m in rw[4]],
                                       rtol=1e-6)
