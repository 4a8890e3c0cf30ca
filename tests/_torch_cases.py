"""Inputs of the port's kernel tests, made with numpy from a seed: one copy
for the CPU tests (which hold the plain versions against the JAX package)
and the `cuda` tests (which hold the kernels against the plain versions on
the card, where jax is not installed). Imports nothing of jax, the JAX
package or ``tools/``.
"""

import numpy as np

from videoquery_torch.nn import bn_inception as bi


# -- K2: image pairs ------------------------------------------------------------

def texture(rng, n, h, w):
    """[n, h, w] smooth f32 images in [0, 1]: coarse noise, box-blurred."""
    base = rng.normal(size=(n, h // 6 + 3, w // 6 + 3))
    img = np.repeat(np.repeat(base, 6, axis=1), 6, axis=2)[:, :h + 6, :w + 6]
    for axis in (1, 2):
        c = np.cumsum(img, axis=axis)
        img = (np.take(c, range(6, c.shape[axis]), axis=axis)
               - np.take(c, range(0, c.shape[axis] - 6), axis=axis)) / 6
    img = img[:, :h, :w]
    lo, hi = img.min(axis=(1, 2), keepdims=True), img.max(axis=(1, 2), keepdims=True)
    return np.ascontiguousarray((img - lo) / (hi - lo), np.float32)


def make_pair(h, w, seed=0, n=2, flow=1.0, images=texture):
    """(I0, I1, u, v): I0 from ``images(rng, n, h, w)``, I1 is I0 shifted
    2 px right plus 1% noise; the flow uniform in [-flow, flow]."""
    rng = np.random.default_rng(seed)
    i0 = images(rng, n, h, w)
    i1 = np.roll(i0, 2, axis=2) + 0.01 * rng.random(i0.shape).astype(np.float32)
    u = rng.uniform(-flow, flow, i0.shape).astype(np.float32)
    v = rng.uniform(-flow, flow, i0.shape).astype(np.float32)
    return i0, i1.astype(np.float32), u, v


# -- T1: one Inception block ---------------------------------------------------

def block_params(name, cin, seed=0, members=None):
    """The block's parameters (numpy, JAX layout) as tests/test_pallas.py
    draws them: ``init_params(0, 3)`` for the 3x3 convs, the 1x1 weights
    redrawn at scale 0.05 for Cin, and biases ~N(0, 0.01); with members, a
    stacked tree whose member m scales every weight and bias by 1 + 0.1 m."""
    rng = np.random.default_rng(seed)
    base = bi.init_params(0, 3)
    p = {}
    for lyr in ("1x1", "3x3_reduce", "double_3x3_reduce", "pool_proj"):
        key = f"{name}/{lyr}"
        cout = base[key]["w"].shape[3]
        p[key] = {"w": (rng.normal(size=(1, 1, cin, cout)) * 0.05).astype(np.float32),
                  "b": (rng.normal(size=cout) * 0.01).astype(np.float32)}
    for lyr in ("3x3", "double_3x3_1", "double_3x3_2"):
        key = f"{name}/{lyr}"
        p[key] = {"w": base[key]["w"],
                  "b": (rng.normal(size=base[key]["b"].shape) * 0.01).astype(np.float32)}
    if members is None:
        return p
    return {k: {"w": np.stack([v["w"] * (1 + 0.1 * m) for m in range(members)]),
                "b": np.stack([v["b"] * (1 + 0.1 * m) for m in range(members)])}
            for k, v in p.items()}


def relu_input(hw, cin, n=5, seed=1):
    """[n, hw, hw, cin] f32 >= 0: a block's input is a ReLU output."""
    x = np.random.default_rng(seed).normal(size=(n, hw, hw, cin)) * 0.3
    return np.maximum(x, 0.0).astype(np.float32)
