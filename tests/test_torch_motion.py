"""The port's camera motion (videoquery_torch.kernels.motion and the camera
half of kernels.tvl1_flow, homography and affine) against the JAX package.

Same numpy-seeded inputs through both; the JAX warps reach the Pallas
window warp, run in interpret mode. Tolerances: the median and the integer
pan are exact; homographies rtol 1e-4 / atol 1e-5 (6 Gauss-Newton steps of
an 8x8 solve whose sums run in another order); the closed-form displacement
helpers rtol 1e-5 / atol 1e-5 px.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videoquery.kernels import motion as jm
from videoquery.kernels import tvl1_pallas as jt
from videoquery.pipeline.extract import PRODUCTION_TVL1 as JAX_PRODUCTION
from videoquery_torch.kernels import motion as tm
from videoquery_torch.kernels import tvl1_flow as tf
from videoquery_torch.kernels.window_warp import window_warp
from videoquery_torch.pipeline.extract import PRODUCTION_TVL1

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def pan_zoom_pairs(n=3, h=48, w=64, seed=0):
    """[n, h, w] pairs of a blurred texture under a pan and a zoom, with a
    small bright object moving on its own."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.random((h * 2, w * 2)).astype(np.float32), (7, 7), 2)
    i0, i1 = [], []
    for k in range(n):
        for out, t in ((i0, 0), (i1, 1)):
            z = 1.0 + 0.02 * t * (k + 1)
            m = np.float32([[z, 0, -20 - (2 + k) * t], [0, z, -10 - (1 - k) * t]])
            fr = cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_REFLECT)
            fr[10:16, 20 + 3 * t:26 + 3 * t] = 0.95
            out.append(fr)
    return np.stack(i0), np.stack(i1)


@pytest.mark.parametrize("count", [768, 767, 4, 3])
def test_median_midpoint_matches_jnp_median(count):
    """jnp.median of an even count averages the two middle values
    (torch.median would return the lower one)."""
    x = np.random.default_rng(count).random((5, count)).astype(np.float32)
    want = np.asarray(jnp.median(jnp.asarray(x), axis=1))
    got = tm.median_midpoint(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if count % 2 == 0:
        assert not np.array_equal(torch.median(torch.from_numpy(x), dim=1).values.numpy(), want)


def test_global_translation_matches_jax():
    i0, i1 = pan_zoom_pairs(4)
    want = np.asarray(jm.global_translation(jnp.asarray(i0), jnp.asarray(i1), 12))
    got = tm.global_translation(torch.from_numpy(i0), torch.from_numpy(i1), 12).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 0


def test_homography_helpers_match_jax():
    rng = np.random.default_rng(1)
    hn = np.eye(3, dtype=np.float32)[None] + rng.normal(size=(4, 3, 3)).astype(np.float32) * 0.02
    hn[:, 2, 2] = 1.0
    tx = rng.normal(size=4).astype(np.float32) * 3
    ty = rng.normal(size=4).astype(np.float32) * 3
    np.testing.assert_array_equal(tm.homography_params(torch.from_numpy(hn)).numpy(),
                                  np.asarray(jm.homography_params(jnp.asarray(hn))))
    ht = tm.homography_translate(torch.from_numpy(hn), torch.from_numpy(tx),
                                 torch.from_numpy(ty), 64, 48).numpy()
    np.testing.assert_allclose(ht, np.asarray(jm.homography_translate(
        jnp.asarray(hn), jnp.asarray(tx), jnp.asarray(ty), 64, 48)), rtol=1e-6, atol=1e-7)
    u, v = tm.homography_displacement(torch.from_numpy(hn), 48, 64)
    uj, vj = jm.homography_displacement(jnp.asarray(hn), 48, 64)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("warm", [False, True])
def test_lk_homography_batch_matches_jax(warm):
    """The LK fit with the window warp (K3's plain version vs the Pallas
    warp in interpret mode), from zero and warm-started."""
    i0, i1 = pan_zoom_pairs(3, seed=2)
    p0 = (np.random.default_rng(3).normal(size=(3, 8)) * 1e-3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.lk_homography_batch(
            jnp.asarray(i0), jnp.asarray(i1),
            warp_fn=lambda img, u, v: jt.window_warp_pallas(img, u, v, d=4),
            n_iters=4, p0=jnp.asarray(p0) if warm else None))
    got = tm.lk_homography_batch(
        torch.from_numpy(i0), torch.from_numpy(i1),
        lambda img, u, v: window_warp(img, u, v, 4), n_iters=4,
        p0=torch.from_numpy(p0) if warm else None).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_estimate_refine_apply_camera_match_jax():
    """estimate_camera (pan + 6 LK iterations), refine_camera (3 warm LK
    iterations through the roll-window warp) and apply_camera, at the
    production camera grid 48x64 from a 64x128 flow grid."""
    i0, i1 = pan_zoom_pairs(3, h=64, w=128, seed=4)
    j0, j1 = jnp.asarray(i0), jnp.asarray(i1)
    t0, t1 = torch.from_numpy(i0), torch.from_numpy(i1)
    with pltpu.force_tpu_interpret_mode():
        hj = jt.estimate_camera(j0, j1, JAX_PRODUCTION, None)
        rj = jt.refine_camera(j0, j1, JAX_PRODUCTION, None, hj, n_iters=3)
        aj = jt.apply_camera(j1, rj)
    ht = tf.estimate_camera(t0, t1, PRODUCTION_TVL1)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=RTOL, atol=ATOL)
    # continue from the JAX homography so each stage is held on its own
    rt = tf.refine_camera(t0, t1, PRODUCTION_TVL1, torch.tensor(np.asarray(hj)),
                          n_iters=3)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RTOL, atol=ATOL)
    at = tf.apply_camera(t1, torch.tensor(np.asarray(rj)))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=1e-5)


def test_roll_pairs_matches_jnp_roll():
    x = np.random.default_rng(5).random((3, 7, 9)).astype(np.float32)
    tx = np.array([2, -3, 11], np.int32)
    ty = np.array([-1, 4, 0], np.int32)
    want = np.stack([np.roll(np.roll(x[i], -ty[i], 0), -tx[i], 1) for i in range(3)])
    got = tf.roll_pairs(torch.from_numpy(x), torch.from_numpy(tx), torch.from_numpy(ty))
    np.testing.assert_array_equal(got.numpy(), want)


def test_affine_camera_is_refused():
    """The affine camera, once refused, now equals the JAX package's: its A
    [N, 2, 3] (pan + 6 affine LK iterations on K3's plain version, scaled
    from the 48x64 camera grid to native coords) and the warped flow of the
    pyramid after it (atol 1e-3 px for all of it, 1e-4 for >= 99.9%, as
    tests/test_torch_flow.py holds the homography's)."""
    import dataclasses

    from videoquery.kernels.tvl1 import TVL1Params as JaxTVL1Params
    from videoquery_torch.kernels.tvl1 import TVL1Params

    i0, i1 = pan_zoom_pairs(3, h=64, w=128, seed=6)
    jp = dataclasses.replace(JAX_PRODUCTION, camera_model="affine", n_scales=2)
    assert isinstance(jp, JaxTVL1Params)
    p = TVL1Params(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    with pltpu.force_tpu_interpret_mode():
        uj, vj, aj = jt.tvl1_warped_flow_pallas_cam(jnp.asarray(i0), jnp.asarray(i1), jp)
    u, v, a = tf.tvl1_warped_flow_cam(torch.from_numpy(i0), torch.from_numpy(i1), p)
    assert a.shape == (3, 2, 3)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=RTOL, atol=ATOL)
    assert np.abs(np.asarray(aj)[:, :, 2]).max() > 1.0     # the pan was found
    for got, want in ((u, uj), (v, vj)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
        assert np.isclose(got, want, rtol=1e-4, atol=1e-4).mean() >= 0.999
