# A frozen copy of videoquery_torch/kernels/resize.py (its plain versions only), for the
# benchmark's reference; it imports nothing of the program.
"""``jax.image.resize(..., method="linear")`` as two matrix products.

JAX's linear resize is separable: along each axis it multiplies by a
[n_out, n_in] weight matrix built from a triangle kernel that is WIDENED by
n_in / n_out on a downscale (antialiasing) and whose columns are
renormalised to sum to one at the edges. ``F.interpolate`` does neither, so
the matrices are built here with JAX's own formula
(``jax._src.image.scale.compute_weight_mat``), in float32 as JAX builds
them, and applied with two matmuls. The pyramid, the flow upsampling, the
camera grid and the gray flow grid all use it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.tvl1._const import device_constant


@functools.lru_cache(maxsize=64)
def linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """float32 [n_out, n_in]: row o holds the weights of output sample o."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))       # [n_in, n_out]
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).T.astype(f32)


def resize2(img: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Linear resize of the last two axes of f32 [..., H, W] to hw."""
    h, w = img.shape[-2:]
    if (h, w) == tuple(hw):
        return img
    dev = img.device
    if h != hw[0]:
        rv = device_constant(("linear", h, hw[0]), lambda: linear_matrix(h, hw[0]), dev)
        img = torch.matmul(rv, img)
    if w != hw[1]:
        rh = device_constant(("linear", w, hw[1]), lambda: linear_matrix(w, hw[1]), dev)
        img = torch.matmul(img, rh.T)
    return img
