"""The port's flow pyramid (videoquery_torch.kernels.{resize,tvl1_flow}) and
the flow half of pipeline.extract against the JAX package.

Same numpy-seeded inputs; JAX's Pallas kernels run in interpret mode.
Tolerances:
- resize matrices and resizes: rtol 1e-5 / atol 1e-6 (JAX's own formula in
  float32; only the order of the column sums may differ);
- unwarped pyramids: rtol 1e-4 / atol 1e-5 for >= 99.9% of the flow and
  1e-4 px for all of it, K2's bound (tests/test_torch_tvl1_level.py says
  why);
- the warped pyramid (camera + pyramid): measured at most 4e-4 px apart at
  flows of ~5 px (one-ulp differences amplified by rgrad through three
  levels), so atol 1e-3 px for all and rtol 1e-4 / atol 1e-4 for >= 99.9%;
- quantized flow: within 1 LSB (20/127.5 native px) everywhere.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videoquery.kernels import tvl1_pallas as jt
from videoquery.kernels.tvl1 import TVL1Params as JaxTVL1Params
from videoquery.pipeline import extract as je
from videoquery.pipeline.sampling import flow_pair_plan, flow_warm_plan
from videoquery_torch.kernels import tvl1_flow as tf
from videoquery_torch.kernels.resize import linear_matrix, resize2
from videoquery_torch.kernels.tvl1 import TVL1Params, _pyramid_shapes
from videoquery_torch.pipeline import extract as te

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)


def port_params(jp) -> TVL1Params:
    return TVL1Params(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def assert_flow_close(got, want, rtol=1e-4, atol=1e-5, atol_all=1e-4):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_all)
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    assert close.mean() >= 0.999, close.mean()


def moving_frames(n, h, w, seed=0):
    """A blurred texture under pan + zoom with an object moving on its own:
    f32 [n, h, w] in [0, 1]."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.random((h * 2, w * 2)).astype(np.float32), (9, 9), 2)
    out = []
    for t in range(n):
        m = np.float32([[1 + 0.01 * t, 0, -2 * t - 10], [0, 1 + 0.01 * t, -t - 10]])
        fr = cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_REFLECT)
        fr[10:20, 20 + 3 * t:30 + 3 * t] = 0.9
        out.append(fr)
    return np.stack(out).astype(np.float32)


PROD = dataclasses.replace(je.PRODUCTION_TVL1, n_scales=2)


@pytest.mark.parametrize("n_in,n_out", [(128, 64), (64, 32), (32, 16), (16, 32),
                                        (32, 64), (64, 128), (128, 48), (256, 128),
                                        (340, 128), (30, 16), (48, 128)])
def test_resize_matrix_matches_jax_image_resize(n_in, n_out):
    """Every pyramid shape of the production grid (128 -> 64 -> 32 -> 16 and
    back), the camera grid (128 -> 48 and 64), the gray grid (256 -> 128,
    340 -> 128) and odd sizes, against jax.image.resize of an identity."""
    want = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32),
                                       (n_out, n_in), method="linear"))
    np.testing.assert_allclose(linear_matrix(n_in, n_out), want, rtol=1e-5, atol=1e-6)


def test_resize2_matches_jax_on_images():
    x = np.random.default_rng(0).random((3, 128, 128)).astype(np.float32)
    for hw in [(48, 64), (64, 64), (256, 96)]:
        want = np.asarray(jax.image.resize(jnp.asarray(x), (3,) + hw, "linear"))
        np.testing.assert_allclose(resize2(torch.from_numpy(x), hw).numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_pyramid_shapes_match_jax():
    from videoquery.kernels.tvl1 import _pyramid_shapes as jax_shapes

    for h, w in [(128, 128), (32, 48), (30, 100)]:
        assert _pyramid_shapes(h, w, port_params(je.PRODUCTION_TVL1)) == \
            jax_shapes(h, w, je.PRODUCTION_TVL1)


def test_tvl1_pyramid_matches_pallas():
    fr = moving_frames(3, 48, 128)
    i0, i1 = fr[:-1], fr[1:]
    p = JaxTVL1Params(n_scales=3, n_warps=2, n_iters=10, grad_source="warped")
    with pltpu.force_tpu_interpret_mode():
        uj, vj = jt.tvl1_flow_pallas(jnp.asarray(i0), jnp.asarray(i1), p)
    u, v = tf.tvl1_flow(torch.from_numpy(i0), torch.from_numpy(i1), port_params(p))
    assert_flow_close(u.numpy(), np.asarray(uj))
    assert_flow_close(v.numpy(), np.asarray(vj))


def test_tvl1_warm_matches_pallas():
    fr = moving_frames(3, 48, 128, seed=1)
    i0, i1 = fr[:-1], fr[1:]
    rng = np.random.default_rng(2)
    u0 = rng.uniform(-2, 2, i0.shape).astype(np.float32)
    v0 = rng.uniform(-1, 1, i0.shape).astype(np.float32)
    p = je.warm_tvl1_params(je.PRODUCTION_TVL1)
    with pltpu.force_tpu_interpret_mode():
        uj, vj = jt.tvl1_flow_pallas_warm(*(jnp.asarray(a) for a in (i0, i1, u0, v0)), p)
    u, v = tf.tvl1_flow_warm(*(torch.from_numpy(a) for a in (i0, i1, u0, v0)),
                             te.warm_tvl1_params(te.PRODUCTION_TVL1))
    assert_flow_close(u.numpy(), np.asarray(uj))
    assert_flow_close(v.numpy(), np.asarray(vj))


def test_warped_pyramid_matches_pallas():
    fr = moving_frames(4, 48, 128, seed=3)
    i0, i1 = fr[:-1], fr[1:]
    with pltpu.force_tpu_interpret_mode():
        uj, vj, hj = jt.tvl1_warped_flow_pallas_cam(jnp.asarray(i0), jnp.asarray(i1), PROD)
    u, v, h = tf.tvl1_warped_flow_cam(torch.from_numpy(i0), torch.from_numpy(i1),
                                      port_params(PROD))
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-4, atol=1e-5)
    for got, want in ((u, uj), (v, vj)):
        assert_flow_close(got.numpy(), np.asarray(want), atol=1e-4, atol_all=1e-3)


@pytest.mark.parametrize("warm_camera", ["init", "own"])
def test_pair_flow_with_warm_plan_quantized(warm_camera):
    """_pair_flow over a warm plan (keys, warm pairs, camera reuse) gives the
    JAX package's quantized flow within one LSB."""
    gray = moving_frames(12, 48, 128, seed=4)[None]
    pair_idx, _ = flow_pair_plan(12, 4, 5)
    plan = flow_warm_plan(pair_idx, 3)
    assert plan[1].size > 0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(je._pair_flow(
            jnp.asarray(gray), jnp.asarray(pair_idx), 20.0, True, PROD, (2.0, 2.0),
            tuple(jnp.asarray(a) for a in plan), warm_camera))
    got = te._pair_flow(torch.from_numpy(gray), torch.as_tensor(pair_idx.astype(np.int64)),
                        20.0, True, port_params(PROD), (2.0, 2.0),
                        tuple(torch.as_tensor(a.astype(np.int64)) for a in plan),
                        warm_camera).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())


def test_rescue_replaces_saturated_pairs_like_jax():
    """A pair whose flow saturates the window is re-solved with a doubled
    window; the others keep their flow."""
    fr = moving_frames(5, 48, 128, seed=5)
    i0, i1 = fr[:-1], fr[1:]
    rng = np.random.default_rng(6)
    u = rng.uniform(-1, 1, i0.shape).astype(np.float32)
    v = rng.uniform(-1, 1, i0.shape).astype(np.float32)
    u[1] = 6.0                          # saturated: pooled peak 6 >= 0.9 * 6
    p = dataclasses.replace(PROD, rescue_frac=0.5)
    with pltpu.force_tpu_interpret_mode():
        uj, vj = je._rescue_fast_motion(*(jnp.asarray(a) for a in (i0, i1, u, v)), True, p)
    ut, vt = te._rescue_fast_motion(*(torch.from_numpy(a) for a in (i0, i1, u, v)), True,
                                    port_params(p))
    np.testing.assert_array_equal(ut.numpy()[[0, 2, 3]], u[[0, 2, 3]])
    assert not np.allclose(ut.numpy()[1], 6.0)
    assert_flow_close(ut.numpy(), np.asarray(uj), atol=1e-4, atol_all=1e-3)
    assert_flow_close(vt.numpy(), np.asarray(vj), atol=1e-4, atol_all=1e-3)


@pytest.mark.parametrize("matmul", [True, False])
def test_flow_gray_grid_matches_jax(matmul):
    """The gray flow grid in f32 on the CPU (the JAX package's CPU rule)."""
    frames = np.random.default_rng(7).integers(0, 255, (2, 3, 64, 300, 3), np.uint8)
    gj, sj = je._flow_gray_grid(jnp.asarray(frames), 2, matmul=matmul)
    gt, st = te._flow_gray_grid(torch.from_numpy(frames), 2, matmul=matmul)
    assert st == sj and tuple(gt.shape) == gj.shape == (2, 3, 32, 128)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)
