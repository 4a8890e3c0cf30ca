# A frozen copy of videoquery_torch/kernels/warp.py (its plain versions only), for the
# benchmark's reference; it imports nothing of the program.
"""Bilinear warps by gathers, batched over a leading axis.

Port of ``videoquery/kernels/warp.py`` (XLA gathers in the JAX package,
outside any Pallas kernel): sample an image at float coordinates with the
coordinates clamped to the border, then floored. The gather TV-L1 solver
(``kernels/tvl1.py``) and its camera warps use them; the production flow
warps with the window-warp kernel K3 instead (``kernels/window_warp.py``).
``roll_pairs`` is the per-pair integer shift both camera paths apply first.
"""

from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(ys, xs) f32 [h, w]: each pixel's row and column."""
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return ys, xs


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample img f32 [N, H, W] at float coords (ys, xs) [N, H', W'] (or
    [H', W'], shared by the batch), border-clamped."""
    n, h, w = img.shape
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    wy = ys - y0
    wx = xs - x0
    shape = torch.broadcast_shapes((n,) + tuple(ys.shape[-2:]), ys.shape)
    flat = img.reshape(n, h * w)
    y0i, y1i = y0.long() * w, y1.long() * w
    x0i, x1i = x0.long(), x1.long()

    def at(yi, xi):
        idx = (yi + xi).expand(shape).reshape(n, -1)
        return torch.gather(flat, 1, idx).reshape(shape)

    return (at(y0i, x0i) * (1 - wy) * (1 - wx)
            + at(y0i, x1i) * (1 - wy) * wx
            + at(y1i, x0i) * wy * (1 - wx)
            + at(y1i, x1i) * wy * wx)


def bilinear_warp(img: torch.Tensor, flow_u: torch.Tensor, flow_v: torch.Tensor
                  ) -> torch.Tensor:
    """Warp img [N, H, W] by flow (u = dx, v = dy): out(y, x) = img(y + v, x + u)."""
    ys, xs = pixel_grid(img.shape[1], img.shape[2], img.device)
    return bilinear_sample(img, ys + flow_v, xs + flow_u)


def warp_affine(img: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Warp img [N, H, W] by affines A [N, 2, 3] mapping output coords to
    source coords: src = A @ [x, y, 1]."""
    ys, xs = pixel_grid(img.shape[1], img.shape[2], img.device)
    a = A[:, :, :, None, None]
    sx = a[:, 0, 0] * xs + a[:, 0, 1] * ys + a[:, 0, 2]
    sy = a[:, 1, 0] * xs + a[:, 1, 1] * ys + a[:, 1, 2]
    return bilinear_sample(img, sy, sx)


def roll_pairs(img: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """Per-pair circular shift: out[n, y, x] = img[n, (y + ty[n]) % H,
    (x + tx[n]) % W] (jnp.roll by -t, one shift per pair)."""
    n, h, w = img.shape
    rows = (torch.arange(h, device=img.device)[None, :] + ty[:, None].long()) % h
    cols = (torch.arange(w, device=img.device)[None, :] + tx[:, None].long()) % w
    out = torch.gather(img, 1, rows[:, :, None].expand(n, h, w))
    return torch.gather(out, 2, cols[:, None, :].expand(n, h, w))
