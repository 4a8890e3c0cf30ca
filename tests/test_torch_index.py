"""The port's FeatureIndex and CSV loading against the JAX package's."""

import os

import numpy as np
import pytest
import torch

from conftest import REFERENCE_FIXTURES
from videoquery.index.store import FeatureIndex as JaxIndex
from videoquery.index.store import FeatureRecord as JaxRecord
from videoquery.service.loader import load_index as jax_load_index
from videoquery_torch.core.config import HyperParams
from videoquery_torch.core.device import resolve_device
from videoquery_torch.index.records import FeatureRecord
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.service.loader import load_index

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

STREAMS = ("rgb", "warped_optical_flow")


@pytest.mark.parametrize("corpus", ["stock-video-clips_features",
                                    "SHRP2_Forward_clips_features"])
def test_load_index_matches_jax(corpus):
    root = os.path.join(REFERENCE_FIXTURES, corpus)
    want = jax_load_index(root)
    got = load_index(root, device="cpu")
    np.testing.assert_array_equal(got.clip_ids, want.clip_ids)
    assert got.feats.dtype == torch.float32
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    # bitwise: the same f64 staging rounded once to f32
    np.testing.assert_array_equal(got.feats.numpy().view(np.uint32),
                                  np.asarray(want.feats).view(np.uint32))
    assert (got.streams, got.splits) == (want.streams, want.splits)


def _records(rng, n_clips=30, dim=8, p_missing=0.2):
    ids = sorted(rng.choice(1000, n_clips, replace=False).tolist())
    rows = []
    for c in ids:
        for s in STREAMS:
            for k in (1, 2, 3):
                if rng.random() > p_missing:
                    rows.append((c, s, k, rng.normal(size=dim)))
    return ids, rows


def test_build_matches_jax(rng):
    ids, rows = _records(rng)
    want = JaxIndex.build([JaxRecord(c, s, k, "global_pool", v) for c, s, k, v in rows],
                          STREAMS, pad_multiple=16, keep_host=True)
    got = FeatureIndex.build([FeatureRecord(c, s, k, "global_pool", v)
                              for c, s, k, v in rows],
                             STREAMS, pad_multiple=16, keep_host=True, device="cpu")
    assert got.n_padded == want.n_padded == 32 and got.n_clips == want.n_clips
    np.testing.assert_array_equal(got.clip_ids, want.clip_ids)
    np.testing.assert_array_equal(got.feats.numpy(), np.asarray(want.feats))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.host_feats, want.host_feats)
    np.testing.assert_array_equal(got.host_mask, want.host_mask)
    for c in ids + [-5]:
        assert got.position(c) == want.position(c)
    target = {"rgb": {1: rng.normal(size=8), "2": rng.normal(size=8)},
              "warped_optical_flow": {3: rng.normal(size=8)}}
    for a, b in zip(got.target_arrays_host(target), want.target_arrays_host(target)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_numpy_carries_jax_index(rng, dtype):
    """A JAX index's arrays, passed as numpy, become the port's index with
    the same bits (bf16 arrives as an ml_dtypes array)."""
    import jax.numpy as jnp

    _, rows = _records(rng)
    jax_index = JaxIndex.build([JaxRecord(c, s, k, "global_pool", v)
                                for c, s, k, v in rows], STREAMS,
                               dtype=jnp.dtype(dtype))
    feats = np.asarray(jax_index.feats)
    tdt = getattr(torch, dtype)
    got = FeatureIndex.from_numpy(
        jax_index.clip_ids, feats, np.asarray(jax_index.mask),
        jax_index.streams, jax_index.splits, jax_index.feature_name,
        device="cpu", dtype=tdt)
    assert got.feats.dtype == tdt
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    np.testing.assert_array_equal(got.feats.view(torch.int16 if dtype == "bfloat16"
                                                 else torch.int32).numpy().view(bits),
                                  feats.view(bits))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jax_index.mask))
    assert got.position(int(jax_index.clip_ids[3])) == 3


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.delenv("VIDEOQUERY_DEVICE", raising=False)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("VIDEOQUERY_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")
    if not torch.cuda.is_available():
        monkeypatch.delenv("VIDEOQUERY_DEVICE")
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")


def test_build_rejects_mismatched_dims(rng):
    rows = [FeatureRecord(1, "rgb", 1, "global_pool", rng.normal(size=8)),
            FeatureRecord(2, "rgb", 1, "global_pool", rng.normal(size=7))]
    with pytest.raises(ValueError):
        FeatureIndex.build(rows, STREAMS, device="cpu")
    with pytest.raises(ValueError):
        FeatureIndex.build(rows, STREAMS, feature_name="fc-action", device="cpu")
    assert HyperParams().streams == STREAMS
