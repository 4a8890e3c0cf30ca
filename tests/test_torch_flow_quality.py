"""The port's flow-quality gate (videoquery_torch.tools.flow_quality)
against the JAX package's tool (tools/flow_quality.py).

- the corpus (v3 and v4, with its truth) and the residual truth flow: bit
  for bit (the same numpy and cv2 code);
- epe_for_config on a 2-class, 5-frame corpus, the gather baseline, the
  production row and warm g5 on the key's camera with and without
  advection on K2/K3 (Pallas in interpret mode on the JAX side): each of
  the 4 numbers within 1e-3 px of the JAX tool's;
- cosine, ranking and partner_accuracy on the same embeddings: equal.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tools import flow_quality as jfq
from videoquery.kernels.tvl1 import TVL1Params as JaxTVL1Params
from videoquery.pipeline.extract import PRODUCTION_TVL1 as JAX_PRODUCTION
from videoquery_torch.kernels.tvl1 import TVL1Params
from videoquery_torch.pipeline.extract import PRODUCTION_TVL1
from videoquery_torch.tools import flow_quality as tfq

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)


def assert_truths_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k in ("persp_mats", "vels"):
                assert (g[k] is None) == (w[k] is None)
                if g[k] is not None:
                    np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("version,scale,frames", [(4, 1, 30), (3, 2, 8)])
def test_make_corpus_matches_jax(version, scale, frames):
    """Corpus v4 at the gate's default size (40 clips of 20 classes) and v3
    at scale 2 (24 of 12), with the truth."""
    got = tfq.make_corpus(frames=frames, seed=1, scale=scale, with_truth=True,
                          version=version)
    want = jfq.make_corpus(frames=frames, seed=1, scale=scale, with_truth=True,
                           version=version)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape[0] == (40 if version == 4 else 24)
    assert_truths_equal(got[2], want[2])
    assert tfq.MOTION_CLASSES == jfq.MOTION_CLASSES and tfq.V4_CLASSES == jfq.V4_CLASSES


def test_truth_residual_flow_matches_jax():
    """Every pair of every clip of a small v4 corpus: the same field and
    mask, or None (wrapped, or the cut pair) in both."""
    _, _, truths = jfq.make_corpus(frames=12, h=48, w=64, seed=2, with_truth=True)
    n_none = 0
    for meta in truths:
        for t in range(11):
            got = tfq.truth_residual_flow(meta, t, 48, 64)
            want = jfq.truth_residual_flow(meta, t, 48, 64)
            assert (got is None) == (want is None)
            if want is None:
                n_none += 1
                continue
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    assert 0 < n_none < 40 * 11


def port_params(jp) -> TVL1Params:
    return TVL1Params(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


@pytest.fixture(scope="module")
def small_corpus():
    """The first 2 classes (4 clips) of a 5-frame 48x64 v4 corpus."""
    clips, labels, truths = jfq.make_corpus(frames=5, h=48, w=64, seed=3,
                                            with_truth=True)
    return clips[:4], labels[:4], truths[:4]


@pytest.mark.parametrize("row", ["baseline", "production", "g5 key", "g5 key advect"])
def test_epe_for_config_matches_jax(small_corpus, row):
    """The default table's baseline (gather solver, full resolution, the
    affine camera, 5 scales x 5 warps x 30 iterations), --final's
    production row (K2/K3 at half resolution, warm groups of 3 refining the
    key's homography, rescue, the gray as matmuls), and --warm's "prod warm
    g5 key advect" row (warm groups of 5 on the key's camera, the key's flow
    advected at d=16) with its partner without advection: each row on its
    own, so the advection's effect on EPE is the JAX tool's as well."""
    clips, _, truths = small_corpus
    kw = {}
    if row == "baseline":
        jp, args = JaxTVL1Params(), ("xla", 1)
    elif row == "production":
        jp, args = JAX_PRODUCTION, ("pallas", 2)
        kw = dict(warm_group=3, warm_camera="init", gray_matmul=True)
    else:
        jp, args = JAX_PRODUCTION, ("pallas", 2)
        kw = dict(warm_group=5, warm_camera="key",
                  warm_advect=16 if row.endswith("advect") else 0)
    with pltpu.force_tpu_interpret_mode():
        want = jfq.epe_for_config(clips, truths, args[0], jp, args[1], **kw)
    got = tfq.epe_for_config(clips, truths, args[0], port_params(jp), args[1],
                             device="cpu", **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(want[k])
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_retrieval_metrics_match_jax():
    rng = np.random.default_rng(4)
    labels = np.repeat(np.arange(6), 2)
    emb = rng.normal(size=(2, 12, 32)) + 2.0 * rng.normal(size=(6, 32))[labels][None]
    np.testing.assert_array_equal(tfq.cosine(emb[0], emb[1]), jfq.cosine(emb[0], emb[1]))
    np.testing.assert_array_equal(tfq.ranking(emb), jfq.ranking(emb))
    assert tfq.partner_accuracy(emb, labels) == jfq.partner_accuracy(emb, labels) > 0.5


def test_p90_is_numpys_linear_percentile():
    """The EPE p90 without torch.nanquantile (it refuses inputs over 2**24
    values): numpy's linear interpolation, at counts whose 0.9 * (n - 1)
    falls on, below and above a half."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 11, 12, 1000, 1001):
        x = rng.random(n).astype(np.float32)
        assert tfq._p90(torch.from_numpy(x)) == pytest.approx(
            float(np.percentile(x.astype(np.float64), 90)), rel=1e-12)
    assert np.isnan(tfq._p90(torch.zeros(0)))


def test_k2_routes_of_the_gate_grids():
    """K2's routes on the default table's grids: the full-resolution row's
    128x176 finest level on the tiles route, the half-resolution 64x88 and
    the 32x44 below it on the band route, and --final's scale-2 grid 128x128
    (and its rescue at d=12) on the band route."""
    full = tfq.k2_routes(128, 176, TVL1Params(fine_warps=2))
    assert full[0] == {"h": 128, "w": 176, "d": 6, "route": "tiles"}
    assert [r["route"] for r in full[1:]] == ["band"] * (len(full) - 1)
    half = tfq.k2_routes(64, 88, PRODUCTION_TVL1)
    assert {(r["h"], r["w"]): r["route"] for r in half}[(32, 44)] == "band"
    assert {r["route"] for r in half} == {"band"}
    final = tfq.k2_routes(128, 128, PRODUCTION_TVL1)
    assert {r["route"] for r in final} == {"band"}
    assert max(r["d"] for r in final) == 12
