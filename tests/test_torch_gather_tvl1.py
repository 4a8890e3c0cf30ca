"""The port's gather-warp TV-L1 (videoquery_torch.kernels.{warp,tvl1}), the
affine camera (kernels.motion, kernels.tvl1_flow), the all-frames clip flow
and warm advection (pipeline.extract) against the JAX package.

Same numpy-seeded inputs through both; JAX's Pallas kernels run in interpret
mode. Tolerances:
- bilinear sample, warp and affine warp: rtol 1e-6 / atol 1e-6 (the same
  expression, gathered);
- lk_affine_batch and the affine camera: rtol 1e-4 / atol 1e-5 (6-8
  Gauss-Newton steps of a 6x6 solve whose sums run in another order);
- the gather solver, both cameras, 4 pairs 32x48 (n_scales 3, n_warps 2,
  n_iters 5): atol 1e-3 px for all the flow, rtol 1e-4 / atol 1e-4 for
  >= 99.9% of it;
- quantized flow (_clip_flow, _pair_flow with warm_advect, an Extractor
  batch): within 1 LSB everywhere, >= 99.9% of bytes equal;
- signatures of an Extractor batch: rtol 1e-4 / atol 1e-5 (BN-Inception in
  f32; test_torch_extract.py).
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videoquery.core.config import ExtractionConfig as JaxExtractionConfig
from videoquery.kernels import motion as jm
from videoquery.kernels import tvl1 as jg
from videoquery.kernels import tvl1_pallas as jt
from videoquery.kernels import warp as jw
from videoquery.kernels.tvl1 import TVL1Params as JaxTVL1Params
from videoquery.nn.tsn import TwoStreamTSN as JaxTSN
from videoquery.pipeline import extract as je
from videoquery.pipeline.sampling import flow_pair_plan, flow_warm_plan
from videoquery_torch.core.config import ExtractionConfig
from videoquery_torch.kernels import motion as tm
from videoquery_torch.kernels import tvl1 as tg
from videoquery_torch.kernels import tvl1_flow as tf
from videoquery_torch.kernels import warp as tw
from videoquery_torch.kernels.tvl1 import TVL1Params
from videoquery_torch.kernels.window_warp import window_warp
from videoquery_torch.nn.tsn import TwoStreamTSN
from videoquery_torch.pipeline import extract as te

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

SMALL = JaxTVL1Params(n_scales=3, n_warps=2, n_iters=5)


def port_params(jp) -> TVL1Params:
    return TVL1Params(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def assert_flow_close(got, want, rtol=1e-4, atol=1e-4, atol_all=1e-3):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_all)
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    assert close.mean() >= 0.999, close.mean()


def assert_within_one_lsb(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())


def moving_frames(n, h, w, seed=0, zoom=0.01):
    """A blurred texture under pan + zoom with an object moving on its own:
    f32 [n, h, w] in [0, 1]."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.random((h * 2, w * 2)).astype(np.float32), (9, 9), 2)
    out = []
    for t in range(n):
        m = np.float32([[1 + zoom * t, 0, -2 * t - 10], [0, 1 + zoom * t, -t - 10]])
        fr = cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_REFLECT)
        fr[8:16, 10 + 3 * t:18 + 3 * t] = 0.9
        out.append(fr)
    return np.stack(out).astype(np.float32)


def pairs(n=4, h=32, w=48, seed=0):
    fr = moving_frames(n + 1, h, w, seed)
    return fr[:-1], fr[1:]


# -- kernels/warp.py ----------------------------------------------------------

@pytest.mark.parametrize("fn", ["sample", "warp", "affine"])
def test_warps_match_jax(fn):
    """bilinear_sample (coords beyond both borders), bilinear_warp and
    warp_affine, batched, against the JAX functions vmapped."""
    rng = np.random.default_rng(1)
    img = rng.random((3, 20, 30)).astype(np.float32)
    u = rng.uniform(-6, 6, img.shape).astype(np.float32)
    v = rng.uniform(-6, 6, img.shape).astype(np.float32)
    A = (np.eye(2, 3, dtype=np.float32)[None]
         + rng.normal(size=(3, 2, 3)).astype(np.float32) * [0.05, 0.05, 3.0])
    t = torch.from_numpy
    if fn == "sample":
        ys = rng.uniform(-3, 23, img.shape).astype(np.float32)
        xs = rng.uniform(-3, 33, img.shape).astype(np.float32)
        want = jax.vmap(jw.bilinear_sample)(*(jnp.asarray(a) for a in (img, ys, xs)))
        got = tw.bilinear_sample(t(img), t(ys), t(xs))
    elif fn == "warp":
        want = jw.bilinear_warp_batch(*(jnp.asarray(a) for a in (img, u, v)))
        got = tw.bilinear_warp(t(img), t(u), t(v))
    else:
        want = jw.warp_affine_batch(jnp.asarray(img), jnp.asarray(A))
        got = tw.warp_affine(t(img), t(A))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# -- kernels/motion.py: the affine fit ------------------------------------------

def test_affine_helpers_match_jax():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(4, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.affine_to_native_coords(torch.from_numpy(A), 2.5, 8 / 3).numpy(),
        np.asarray(jm.affine_to_native_coords(jnp.asarray(A), 2.5, 8 / 3)))
    np.testing.assert_array_equal(tm.affine_to_warp(torch.from_numpy(A), 5, 7).numpy(),
                                  np.asarray(jm.affine_to_warp(jnp.asarray(A), 5, 7)))


@pytest.mark.parametrize("warp", ["bilinear", "window"])
def test_lk_affine_batch_matches_jax(warp):
    """The affine LK fit with the bilinear gather (the gather solver's) and
    with K3's plain version against the Pallas window warp in interpret
    mode (the production camera's); the JAX gradient and 6x6 solve against
    torch.gradient and torch.linalg.solve."""
    i0, i1 = pairs(3, 48, 64, seed=3)
    if warp == "bilinear":
        want = jm.lk_affine_batch(jnp.asarray(i0), jnp.asarray(i1), n_iters=6)
        fn = tw.bilinear_warp
    else:
        with pltpu.force_tpu_interpret_mode():
            want = jm.lk_affine_batch(
                jnp.asarray(i0), jnp.asarray(i1),
                warp_fn=lambda img, u, v: jt.window_warp_pallas(img, u, v, d=4), n_iters=6)
        fn = lambda img, u, v: window_warp(img, u, v, 4)  # noqa: E731
    got = tm.lk_affine_batch(torch.from_numpy(i0), torch.from_numpy(i1), fn, n_iters=6)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert np.abs(want[:, :, 2]).max() > 0.5      # it found the pan


def test_affine_apply_camera_matches_jax():
    """The affine camera's warp: an integer roll by the displacement at the
    frame's centre, then the residual through K3 at d=4."""
    rng = np.random.default_rng(4)
    img = moving_frames(3, 48, 64, seed=5)
    A = (rng.normal(size=(3, 2, 3)) * [0.02, 0.02, 6.0]).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jt.apply_camera(jnp.asarray(img), jnp.asarray(A))
    got = tf.apply_camera(torch.from_numpy(img), torch.from_numpy(A))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- kernels/tvl1.py: the gather solver ------------------------------------------

def test_gather_tvl1_flow_matches_jax():
    i0, i1 = pairs()
    uj, vj = jg.tvl1_flow(jnp.asarray(i0), jnp.asarray(i1), SMALL)
    u, v = tg.tvl1_flow(torch.from_numpy(i0), torch.from_numpy(i1), port_params(SMALL))
    assert_flow_close(u.numpy(), np.asarray(uj))
    assert_flow_close(v.numpy(), np.asarray(vj))
    assert np.abs(np.asarray(uj)).mean() > 0.5


@pytest.mark.parametrize("camera", ["affine", "homography"])
def test_gather_warped_flow_matches_jax(camera):
    """Both camera branches, the camera estimated on the solver's own
    64x96 grid."""
    i0, i1 = pairs(seed=6)
    p = dataclasses.replace(SMALL, camera_model=camera)
    uj, vj = jg.tvl1_warped_flow(jnp.asarray(i0), jnp.asarray(i1), p)
    u, v = tg.tvl1_warped_flow(torch.from_numpy(i0), torch.from_numpy(i1), port_params(p))
    assert_flow_close(u.numpy(), np.asarray(uj))
    assert_flow_close(v.numpy(), np.asarray(vj))


def test_gather_pieces_match_jax():
    """The forward differences, divergence and centred gradients of one
    image against the JAX ones."""
    x = np.random.default_rng(7).random((2, 9, 13)).astype(np.float32)
    y = np.random.default_rng(8).random((2, 9, 13)).astype(np.float32)
    for k in range(2):
        for got, want in zip(tg._forward_diff(torch.from_numpy(x))
                             + tg._centered_grad(torch.from_numpy(x))
                             + (tg._divergence(torch.from_numpy(x), torch.from_numpy(y)),),
                             jg._forward_diff(jnp.asarray(x[k]))
                             + jg._centered_grad(jnp.asarray(x[k]))
                             + (jg._divergence(jnp.asarray(x[k]), jnp.asarray(y[k])),)):
            np.testing.assert_array_equal(got.numpy()[k], np.asarray(want))


# -- pipeline/extract.py -------------------------------------------------------

CLIP_FLOW = JaxTVL1Params(n_scales=2, n_warps=1, n_iters=4, grad_source="warped",
                          camera_model="homography")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_clip_flow_matches_jax(impl):
    """Every pair of two 5-frame clips, quantized, the last flow repeated; the
    gather solver with the affine camera, K2/K3 with the homography."""
    gray = np.stack([moving_frames(5, 32, 48, seed=9), moving_frames(5, 32, 48, seed=10)])
    p = SMALL if impl == "xla" else CLIP_FLOW
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(je._clip_flow(jnp.asarray(gray), 20.0, True, p, impl, (2.0, 2.0)))
    got = te._clip_flow(torch.from_numpy(gray), 20.0, True, port_params(p), impl,
                        (2.0, 2.0)).numpy()
    assert got.shape == (2, 5, 32, 48, 2)
    np.testing.assert_array_equal(got[:, -1], got[:, -2])
    assert_within_one_lsb(got, want)


@pytest.mark.parametrize("camera", ["key", "own"])
def test_pair_flow_with_warm_advect_matches_jax(camera):
    """A warm group of 5 with its start advected through K3 at d=16, the
    window --warm's "prod warm g5 key advect" row uses."""
    gray = moving_frames(12, 48, 128, seed=11)[None]
    pair_idx, _ = flow_pair_plan(12, 4, 5)
    plan = flow_warm_plan(pair_idx, 5)
    assert plan[1].size > 0
    p = dataclasses.replace(je.PRODUCTION_TVL1, n_scales=2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(je._pair_flow(
            jnp.asarray(gray), jnp.asarray(pair_idx), 20.0, True, p, (2.0, 2.0),
            tuple(jnp.asarray(a) for a in plan), camera, 16))
    got = te._pair_flow(torch.from_numpy(gray), torch.as_tensor(pair_idx.astype(np.int64)),
                        20.0, True, port_params(p), (2.0, 2.0),
                        tuple(torch.as_tensor(a.astype(np.int64)) for a in plan),
                        camera, 16).numpy()
    assert_within_one_lsb(got, want)
    plain = te._pair_flow(torch.from_numpy(gray), torch.as_tensor(pair_idx.astype(np.int64)),
                          20.0, True, port_params(p), (2.0, 2.0),
                          tuple(torch.as_tensor(a.astype(np.int64)) for a in plan),
                          camera, 0).numpy()
    assert not np.array_equal(got, plain)          # the advection took effect


def synthetic_frames(n=20, h=64, w=96, seed=0):
    """BGR uint8 [n, h, w, 3]: pan + zoom of a blurred texture and a moving
    bright square (2 full 10-frame clips at fps 5)."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 255, (h * 2, w * 2, 3), np.uint8), (9, 9), 3)
    out = []
    for i in range(n):
        z = 1.0 + 0.01 * i
        m = np.float32([[z, 0, -10 - 2 * i], [0, z, -8 - i]])
        fr = cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_REFLECT)
        fr[20:30, 10 + 3 * i:20 + 3 * i] = (230, 240, 250)
        out.append(fr)
    return np.stack(out)


CFG = dict(fps=5, clip_seconds=2, num_ticks=3, frame_resize=(96, 64), crop_size=64,
           batch_clips=2, min_tail_seconds=1, decode_at_target=False)


@pytest.mark.parametrize("impl,camera", [("pallas", "affine"), ("xla", "homography")])
def test_extractor_batch_matches_jax(impl, camera, monkeypatch):
    """One Extractor batch of two clips: the affine camera on K2/K3 (a warm
    group of 3 reusing the key's camera: "init" refines homographies only),
    and the all-frames gather path (stacks through flow_stack_index_matrix);
    same weights in both packages.

    As in tests/test_torch_compact.py: the two solvers sum in another order,
    so a quantized flow byte may differ by one LSB, which at these small
    random nets moves a flow signature past rtol 1e-4. So the JAX run takes
    the port's quantized flow (its flow function swapped), and the port's
    flow is held to the JAX function's on the batch's gray on its own."""
    frames = synthetic_frames()
    jtsn = JaxTSN.random(jax.random.PRNGKey(0), splits=(1,))
    unstack = lambda st: {1: jax.tree.map(lambda a: np.asarray(a[0]), st)}  # noqa: E731
    ptsn = TwoStreamTSN.from_jax_params(unstack(jtsn.rgb.stacked_params),
                                        unstack(jtsn.flow.stacked_params), device="cpu")
    p = dataclasses.replace(CLIP_FLOW, camera_model=camera)
    name = "_pair_flow" if impl == "pallas" else "_clip_flow"
    flows, real = [], getattr(te, name)

    def record(*args):
        flows.append(real(*args))
        return flows[-1]

    monkeypatch.setattr(te, name, record)
    pex = te.Extractor(ptsn, ExtractionConfig(**CFG), warped=True, tvl1=port_params(p),
                       device="cpu", flow_impl=impl)
    psig = te.gather_signatures(list(pex.extract_frames(frames)))
    assert len(flows) == 1

    jex = je.Extractor(jtsn, JaxExtractionConfig(**CFG), warped=True, tvl1=p, flow_impl=impl)
    monkeypatch.setattr(je, name, lambda *a, **k: jnp.asarray(flows[0].numpy()))
    je._extract_step.clear_cache()
    try:
        jsig = je.gather_signatures(list(jex.extract_frames(frames)))
    finally:
        je._extract_step.clear_cache()   # drop the trace of the swapped flow
    monkeypatch.undo()
    assert [s.clip_numbers for s in psig] == [s.clip_numbers for s in jsig] == [[1, 2]]
    for got, want in ((psig[0].rgb, jsig[0].rgb), (psig[0].flow, jsig[0].flow)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    gray, vscale = je._flow_gray_grid(jnp.asarray(frames.reshape(2, 10, 64, 96, 3)), 2)
    with pltpu.force_tpu_interpret_mode():
        if impl == "xla":
            want = je.clip_flow(gray, bound=20.0, warped=True, tvl1=p, impl=impl,
                                value_scale=vscale)
        else:
            _, _, _, pair_idx, warm = jex._plan_arrays(10)
            want = jax.jit(je._pair_flow, static_argnames=(
                "bound", "warped", "tvl1", "value_scale", "warm_camera"))(
                gray, pair_idx, bound=20.0, warped=True, tvl1=p, value_scale=vscale,
                warm_plan=warm, warm_camera="init")
    assert_within_one_lsb(flows[0].numpy(), np.asarray(want))


def test_extractor_refuses_an_unknown_flow_impl():
    tsn = TwoStreamTSN.random(0, splits=(1,), device="cpu")
    with pytest.raises(ValueError, match="flow_impl"):
        te.Extractor(tsn, ExtractionConfig(), device="cpu", flow_impl="gather")
