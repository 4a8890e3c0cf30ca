"""The port's SimilarityTable.valid_positions / similarities_dict and
FeatureIndex.from_feature_dicts against the JAX package.

- similarities_dict against tests/oracles.py's dict-and-loop oracle as
  tests/test_scoring.py holds the JAX method (rtol 2e-6, atol 1e-7, counts
  equal), and against the JAX method's dict on the same index (the same
  keys and counts, values within the same tolerance);
- valid_positions equal to the JAX method's;
- from_feature_dicts gives the index ``build`` gives: clip ids, mask and
  features equal.
"""

import numpy as np
import pytest
import torch

from oracles import make_sparse_problem, oracle_similarities
from videoquery.index.store import FeatureIndex as JaxFeatureIndex
from videoquery.index.store import FeatureRecord as JaxFeatureRecord
from videoquery.search.engine import SearchEngine as JaxSearchEngine
from videoquery_torch.index.records import FeatureRecord
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.search.engine import SearchEngine

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)


def records(streams, splits, candidates, record):
    return [record(c, s, k, "global_pool", np.asarray(v))
            for s in streams for k in splits for c, v in candidates[s][k].items()]


def per_clip(candidates):
    out: dict = {}
    for s, by_split in candidates.items():
        for k, by_clip in by_split.items():
            for c, v in by_clip.items():
                out.setdefault(c, {}).setdefault(s, {})[k] = v
    return out


@pytest.mark.parametrize("p_missing", [0.0, 0.25, 0.6])
def test_similarities_dict_matches_oracle_and_jax(rng, p_missing):
    streams, splits, _ids, target, candidates = make_sparse_problem(rng, p_missing=p_missing)
    index = FeatureIndex.build(records(streams, splits, candidates, FeatureRecord), streams,
                               splits, feature_dim=16, device="cpu")
    table = SearchEngine(index).compute_similarities(target)
    got = table.similarities_dict()
    want = oracle_similarities(target, candidates)
    jindex = JaxFeatureIndex.build(records(streams, splits, candidates, JaxFeatureRecord),
                                   streams, splits, feature_dim=16)
    jtable = JaxSearchEngine(jindex).compute_similarities(target)
    jgot = jtable.similarities_dict()
    assert list(got) == list(jgot) == sorted(want)
    for clip in want:
        assert set(got[clip]) == set(want[clip]) == set(jgot[clip])
        for stream in want[clip]:
            np.testing.assert_allclose(got[clip][stream][0], want[clip][stream][0],
                                       rtol=2e-6, atol=1e-7)
            np.testing.assert_allclose(got[clip][stream][0], jgot[clip][stream][0],
                                       rtol=2e-6, atol=1e-7)
            assert got[clip][stream][1] == want[clip][stream][1] == jgot[clip][stream][1]
    np.testing.assert_array_equal(table.valid_positions(), jtable.valid_positions())
    n = index.n_clips
    want_valid = np.flatnonzero((table.counts[:, :n] > 0).all(axis=0))
    np.testing.assert_array_equal(table.valid_positions(), want_valid)


def test_from_feature_dicts_equals_build(rng):
    streams, splits, _ids, _target, candidates = make_sparse_problem(rng, p_missing=0.3)
    built = FeatureIndex.build(records(streams, splits, candidates, FeatureRecord), streams,
                               feature_dim=16, device="cpu")
    got = FeatureIndex.from_feature_dicts(per_clip(candidates), streams, feature_dim=16,
                                          device="cpu")
    jgot = JaxFeatureIndex.from_feature_dicts(per_clip(candidates), streams, feature_dim=16)
    np.testing.assert_array_equal(got.clip_ids, built.clip_ids)
    np.testing.assert_array_equal(got.clip_ids, jgot.clip_ids)
    assert got.splits == built.splits == tuple(jgot.splits)
    assert torch.equal(got.mask, built.mask)
    assert torch.equal(got.feats, built.feats)
    np.testing.assert_array_equal(got.feats.numpy(), np.asarray(jgot.feats))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jgot.mask))
