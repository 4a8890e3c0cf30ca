"""K2 (videoquery_torch.kernels.tvl1_level) against the JAX package.

On the CPU the wrapper runs K2's plain PyTorch version; it is held here
against tvl1_level_pallas run in interpret mode on the same numpy-seeded
inputs, in the TPU kernel's three warp modes (warped + separable, the
production mode; image + separable; image + full), at a width that the
TPU kernel pads to 128 lanes and so reads wrapped-around columns (64), one
that it does not (128), a ragged width and height, and the production
level schedule.

Tolerance: rtol 1e-4 / atol 1e-5 (tests/test_pallas.py's Pallas-vs-XLA
bound) for at least 99.9% of the flow, and 1e-4 px for all of it. Measured:
at most 2.4e-5 px apart, in 0.05% of the elements. The cause: XLA on the
CPU contracts the warp's multiply-adds into FMAs, the port rounds the
product and the sum as written (as the CUDA kernel does), and the one-ulp
difference of the warped image is multiplied by rgrad = 1 / max(|grad|^2,
1e-6) in flat regions. The CUDA kernel itself is held against the plain
version by the `cuda` test and by chip_smoke.py (bitwise equal there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videoquery.kernels.tvl1 import TVL1Params as JaxTVL1Params
from videoquery.kernels.tvl1_pallas import tvl1_level_pallas
from videoquery.pipeline.extract import PRODUCTION_TVL1 as JAX_PRODUCTION
from videoquery_torch.kernels import tvl1_level as k2
from videoquery_torch.kernels.tvl1 import TVL1Params
from videoquery_torch.kernels.window_warp import PaddedGeometry

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
MODES = {
    "warped_separable": dict(grad_source="warped", separable_warp=True),
    "image_separable": dict(grad_source="image", separable_warp=True),
    "image_full": dict(grad_source="image", separable_warp=False),
}


def port_params(jp: JaxTVL1Params) -> TVL1Params:
    return TVL1Params(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def texture(rng, n, h, w):
    base = jnp.asarray(rng.normal(size=(n, max(h // 6, 2), max(w // 6, 2))))
    img = jax.image.resize(base, (n, h, w), "cubic")
    lo = img.min(axis=(1, 2), keepdims=True)
    hi = img.max(axis=(1, 2), keepdims=True)
    return np.array((img - lo) / (hi - lo), np.float32)


def make_pair(h, w, seed=0, n=2, flow=1.0):
    rng = np.random.default_rng(seed)
    i0 = texture(rng, n, h, w)
    i1 = np.roll(i0, 2, axis=2) + 0.01 * rng.random(i0.shape).astype(np.float32)
    u = rng.uniform(-flow, flow, i0.shape).astype(np.float32)
    v = rng.uniform(-flow, flow, i0.shape).astype(np.float32)
    return i0, i1.astype(np.float32), u, v


def assert_flow_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=10 * ATOL)
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert close.mean() >= 0.999, close.mean()


def run_both(arrays, jp: JaxTVL1Params, d: int):
    with pltpu.force_tpu_interpret_mode():
        uw, vw = tvl1_level_pallas(*(jnp.asarray(a) for a in arrays), jp, d)
    ug, vg = k2.tvl1_level(*(torch.from_numpy(a) for a in arrays), port_params(jp), d)
    return (np.asarray(uw), np.asarray(vw)), (ug.numpy(), vg.numpy())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("hw", [(30, 64), (32, 128), (20, 100)])
def test_plain_matches_pallas_kernel(mode, hw):
    jp = JaxTVL1Params(n_scales=1, n_warps=2, n_iters=8, **MODES[mode])
    (uw, vw), (ug, vg) = run_both(make_pair(*hw, seed=hw[1]), jp, d=3)
    assert_flow_close(ug, uw)
    assert_flow_close(vg, vw)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_production_level_schedule(level):
    """PRODUCTION_TVL1.at_level(level) at its window, on the padded widths
    the production pyramid has below 128 (all read wrapped columns)."""
    size = 128 >> level
    d = max(2, round(6 * 0.5 ** level))
    jp = JAX_PRODUCTION.at_level(level)
    (uw, vw), (ug, vg) = run_both(make_pair(min(size, 32), size, seed=level,
                                            flow=d / 2), jp, d)
    assert_flow_close(ug, uw)
    assert_flow_close(vg, vw)


def test_window_reads_wrap_modulo_the_padded_width():
    """At the coarse production widths (64, 32, 16 -> wp = ww = 128) the
    horizontal pass of the padded domain's right columns reads columns
    (x + d+1 + k) mod ww, as the TPU kernel's circular roll does: here the
    left margin of the window image, not its right edge."""
    from videoquery_torch.kernels.window_warp import hpass

    for w in (64, 32, 16):
        g = PaddedGeometry(16, w, 3)
        assert g.wp == g.ww == 128
    t = torch.arange(128, dtype=torch.float32).repeat(1, 8, 1)   # t[y, X] = X
    u = torch.full((1, 8, 128), 3.0)                               # k0 = d = 3
    out = hpass(t, u, 3)
    np.testing.assert_array_equal(out[0, 0].numpy(),
                                  ((np.arange(128) + 4 + 3) % 128).astype(np.float32))


def test_warp_mode_mapping():
    assert k2.warp_mode(TVL1Params(grad_source="warped")) == k2.MODE_WARPED
    assert k2.warp_mode(TVL1Params(grad_source="image")) == k2.MODE_IMAGE
    # the TPU kernel warps all three images in full mode whatever grad_source
    assert k2.warp_mode(TVL1Params(grad_source="warped",
                                   separable_warp=False)) == k2.MODE_FULL


@pytest.mark.parametrize("case", ["i0_f64", "i1_shape", "u_device_meta", "d0"])
def test_wrapper_rejects_bad_operands(case):
    i0, i1, u, v = (torch.from_numpy(a) for a in make_pair(16, 16))
    d = 2
    if case == "i0_f64":
        i0 = i0.double()
    elif case == "i1_shape":
        i1 = i1[:, :8]
    elif case == "u_device_meta":
        u = u.to("meta")
    else:
        d = 0
    with pytest.raises(ValueError):
        k2.tvl1_level(i0, i1, u, v, TVL1Params(), d)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cuda_kernel_matches_plain_version(mode):
    """K2 against its plain version on the card (wrapping width, ragged
    height); one C call per level."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; K2 has no CPU or interpret mode")
    p = TVL1Params(n_scales=1, n_warps=2, n_iters=8, **MODES[mode])
    args = [torch.from_numpy(a).cuda() for a in make_pair(30, 64, n=4)]
    launches = k2.LAUNCHES
    u, v = k2.tvl1_level(*args, p, 3)
    assert k2.LAUNCHES == launches + 1
    ur, vr = k2.tvl1_level_reference(*args, p, 3)
    torch.testing.assert_close(u, ur, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(v, vr, rtol=RTOL, atol=ATOL)
