"""K3 (videoquery_torch.kernels.window_warp) against the JAX package.

On the CPU the wrapper runs K3's plain PyTorch version; it is held here
against window_warp_pallas run in interpret mode (as tests/test_pallas.py
runs it), on the same numpy-seeded inputs: both modes, windows d = 2 and 4,
rough random flow (beyond the clamp, where the separable warp's error is
largest: it must be reproduced, not replaced by exact bilinear) and smooth
flow, widths 64, 100 and 128 (one padded to 128 lanes, one ragged) and a
ragged height. Tolerance rtol 1e-5 / atol 1e-6: the same two-tap sums, so
only the contraction of a product into a sum may differ. The CUDA kernel
itself is held against the plain version by the `cuda` test and by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videoquery.kernels.tvl1_pallas import window_warp_pallas
from videoquery.kernels.warp import bilinear_warp
from videoquery_torch.kernels import window_warp as k3

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def make_case(h, w, d, rough, seed=0, n=2):
    rng = np.random.default_rng(seed)
    img = rng.random((n, h, w)).astype(np.float32)
    if rough:
        u = rng.uniform(-d - 1, d + 1, (n, h, w)).astype(np.float32)
        v = rng.uniform(-d - 1, d + 1, (n, h, w)).astype(np.float32)
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        u = np.broadcast_to(np.sin(xx / 9.0) * 0.8 * d, (n, h, w)).astype(np.float32)
        v = np.broadcast_to(np.cos(yy / 7.0) * 0.7 * d, (n, h, w)).astype(np.float32)
    return img, np.ascontiguousarray(u), np.ascontiguousarray(v)


@pytest.mark.parametrize("hw", [(30, 64), (32, 100), (24, 128)])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("separable", [True, False])
@pytest.mark.parametrize("rough", [True, False])
def test_plain_matches_pallas_kernel(hw, d, separable, rough):
    img, u, v = make_case(*hw, d, rough, seed=d + 7 * rough)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(window_warp_pallas(jnp.asarray(img), jnp.asarray(u),
                                             jnp.asarray(v), d=d,
                                             separable=separable))
    got = k3.window_warp(torch.from_numpy(img), torch.from_numpy(u),
                         torch.from_numpy(v), d, separable).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_separable_is_not_exact_bilinear_on_rough_flow():
    """The separable result differs from exact bilinear where the flow is
    rough (the error the TPU kernel has), and full mode does not."""
    img, u, v = make_case(32, 64, 4, rough=True, seed=3, n=1)
    want = np.asarray(bilinear_warp(jnp.asarray(img[0]),
                                    jnp.clip(jnp.asarray(u[0]), -4, 4),
                                    jnp.clip(jnp.asarray(v[0]), -4, 4)))
    args = [torch.from_numpy(a) for a in (img, u, v)]
    sep = k3.window_warp(*args, 4, True).numpy()[0]
    full = k3.window_warp(*args, 4, False).numpy()[0]
    inner = (slice(5, -5), slice(5, -5))
    np.testing.assert_allclose(full[inner], want[inner], rtol=1e-5, atol=1e-5)
    assert np.abs(sep[inner] - want[inner]).max() > 1e-2


@pytest.mark.parametrize("case", ["img_f64", "img_2d", "u_shape", "v_dtype", "d0"])
def test_wrapper_rejects_bad_operands(case):
    img, u, v = (torch.from_numpy(a) for a in make_case(16, 16, 2, False))
    d = 2
    if case == "img_f64":
        img = img.double()
    elif case == "img_2d":
        img = img[0]
    elif case == "u_shape":
        u = u[:, :8]
    elif case == "v_dtype":
        v = v.half()
    else:
        d = 0
    with pytest.raises(ValueError):
        k3.window_warp(img, u, v, d)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(30, 100), (30, 101)])
@pytest.mark.parametrize("separable", [True, False])
def test_cuda_kernel_matches_plain_version(separable, hw):
    """K3 against its plain version on the card, rough flow: a width that is
    a multiple of 4 (four pixels a thread, 16-byte loads and stores) and a
    ragged one (a pixel a thread), both with a ragged height; one launch per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; K3 has no CPU or interpret mode")
    img, u, v = (torch.from_numpy(a).cuda() for a in make_case(*hw, 4, True, n=5))
    launches = k3.LAUNCHES
    got = k3.window_warp(img, u, v, 4, separable)
    assert k3.LAUNCHES == launches + 1
    want = k3.window_warp_reference(img, u, v, 4, separable)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
