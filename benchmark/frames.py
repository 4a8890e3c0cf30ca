"""The extraction cells' frames: textured camera pans, made on the host."""

from __future__ import annotations

import numpy as np


def textured_motion_frames(batch: int, frames: int, h: int, w: int, rng,
                           pan_speed=((0.5, 2.5), (-1.0, 1.0)),
                           obj_speed=((-4.0, 4.0), (-3.0, 3.0))) -> np.ndarray:
    """Coherent multi-scale textures with a camera pan + a moving object
    (the flow-quality corpus recipe at bench geometry): the representative
    extraction input, on which the fast-motion rescue fires rarely, as on
    real video.

    A copy of ``videoquery_torch/tools/bench.py``'s (itself bench.py's),
    with the ranges of the pan's and the object's speeds (pixels a frame,
    x then y) as arguments; at their defaults, the same bytes from the same
    generator."""
    import cv2

    def texture(hh, ww, cell):
        n = rng.random((hh // cell + 2, ww // cell + 2, 3))
        t = cv2.resize(n, (ww, hh), interpolation=cv2.INTER_CUBIC)
        t -= t.min()
        return (t / max(t.max(), 1e-9) * 255).astype(np.uint8)

    def pingpong(x, lim):
        # reflect instead of wrap: a modulo wrap is a scene cut that fires
        # the fast-motion rescue — rare in real clips, not representative
        x = int(abs(x)) % (2 * lim)
        return x if x < lim else 2 * lim - 1 - x

    out = np.empty((batch, frames, h, w, 3), np.uint8)
    osz = 48
    for b in range(batch):
        base = texture(2 * h, 2 * w, 24) // 2 + texture(2 * h, 2 * w, 6) // 2
        obj = texture(osz, osz, 8)
        pvx, pvy = rng.uniform(*pan_speed[0]), rng.uniform(*pan_speed[1])
        ovx, ovy = rng.uniform(*obj_speed[0]), rng.uniform(*obj_speed[1])
        for t in range(frames):
            ox, oy = pingpong(t * pvx, w), pingpong(t * pvy, h)
            f = base[oy:oy + h, ox:ox + w].copy()
            px = pingpong(60 + t * ovx, w - osz)
            py = pingpong(40 + t * ovy, h - osz)
            f[py:py + osz, px:px + osz] = obj
            out[b, t] = f
    return out
