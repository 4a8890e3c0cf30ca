"""Global (camera) motion for warped optical flow.

Port of ``videoquery/kernels/motion.py``: the integer pan of a pair from
one grouped cross-correlation, and direct 6-parameter affine and
8-parameter homography fits (Gauss-Newton on intensities, Lucas-Kanade)
with a pluggable batched warp. Homographies are in normalized coordinates
(xn = 2x/W - 1), so one fit applies on any grid of the same field of view;
an affine fit is in its grid's pixel coordinates
(``affine_to_native_coords`` moves it to another grid). The single-pair
fits are here too: ``estimate_affine`` (an IRLS affine fit to a flow
field) and ``lk_affine`` (the one-pair LK that ``lk_affine_batch``
batches).

Numbers: the cross-correlation is a convolution and its argmax moves under
TF32, so callers turn TF32 off (the extractor does); ``jnp.median`` of an
even count is the mean of the two middle values, which ``median_midpoint``
reproduces (``torch.median`` returns the lower one). The small solves use
``torch.linalg.solve_ex``: ``torch.linalg.solve`` computes the same
result and then reads the error code back, which makes the host wait for
the card; ``jnp.linalg.solve`` checks nothing either.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from videoquery_torch.core.transfer import device_constant
from videoquery_torch.kernels.warp import bilinear_sample, pixel_grid

WarpFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _normalized_grid(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    sxn, syn = 2.0 / w, 2.0 / h
    return xs * sxn - 1.0, ys * syn - 1.0, sxn, syn


def median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as jnp.median computes it: the two middle
    order statistics averaged, (lo + hi) * 0.5."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def global_translation(c0: torch.Tensor, c1: torch.Tensor,
                       max_shift: int = 12) -> torch.Tensor:
    """Integer global translation per pair by zero-mean cross-correlation
    (one grouped convolution). c0, c1 f32 [N, H, W] -> int32 [N, 2] (dx, dy):
    c1 shifted by -t aligns with c0."""
    n, h, w = c0.shape
    a = c0 - c0.mean(dim=(1, 2), keepdim=True)
    b = c1 - c1.mean(dim=(1, 2), keepdim=True)
    m = max_shift
    kern = b[:, m:h - m, m:w - m][:, None]               # [N, 1, h-2m, w-2m]
    corr = F.conv2d(a[None], kern, groups=n)[0]           # [N, 2m+1, 2m+1]
    idx = torch.argmax(corr.reshape(n, -1), dim=1)        # first maximum
    dy = idx // (2 * m + 1) - m
    dx = idx % (2 * m + 1) - m
    return torch.stack([-dx, -dy], dim=1).to(torch.int32)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 b without reading the error code back (see the module's text)."""
    return torch.linalg.solve_ex(a, b)[0]


def estimate_affine(flow_u: torch.Tensor, flow_v: torch.Tensor, n_irls: int = 3,
                    delta: float = 1.0) -> torch.Tensor:
    """Fit (u, v) ~ affine(x, y) to one flow field f32 [H, W]: the 2x3 A
    with src = [x, y] + A @ [x, y, 1] the background motion. IRLS with the
    weight min(1, delta / |residual|) lets independently moving foreground
    count less. A is in this grid's pixel coordinates."""
    h, w = flow_u.shape
    dev = flow_u.device
    xn, yn, sx, sy = _normalized_grid(h, w, dev)
    g = torch.stack([xn.reshape(-1), yn.reshape(-1),
                     torch.ones(h * w, dtype=torch.float32, device=dev)], dim=1)  # [N, 3]
    u = flow_u.reshape(-1)
    v = flow_v.reshape(-1)
    eye = 1e-6 * torch.eye(3, dtype=torch.float32, device=dev)

    def solve(weights):
        gw = g * weights[:, None]
        gtg = g.T @ gw + eye
        return _solve(gtg, gw.T @ u), _solve(gtg, gw.T @ v)

    au, av = solve(torch.ones_like(u))
    for _ in range(n_irls):
        ru = g @ au - u
        rv = g @ av - v
        r = torch.sqrt(ru * ru + rv * rv + 1e-8)
        au, av = solve(torch.clamp(delta / r, max=1.0))
    return torch.stack([
        torch.stack([au[0] * sx, au[1] * sy, au[2] - au[0] - au[1]]),
        torch.stack([av[0] * sx, av[1] * sy, av[2] - av[0] - av[1]]),
    ])


def affine_to_native_coords(A: torch.Tensor, rx: float, ry: float) -> torch.Tensor:
    """An affine fitted at coarse-grid coordinates (values already in native
    px) at native coordinates, x_c = x_n / rx: the linear terms divide by
    the ratio, the translation stays. [2, 3] or [N, 2, 3]."""
    return A * device_constant(("native_coords", rx, ry),
                               lambda: np.float32([1.0 / rx, 1.0 / ry, 1.0]), A.device)


def affine_camera(A: torch.Tensor, t: torch.Tensor, hw: tuple[int, int],
                  coarse_hw: tuple[int, int]) -> torch.Tensor:
    """The camera of an affine LK fit A [N, 2, 3] made on a coarse grid of a
    pair pre-shifted by the integer pan t [N, 2] (dx, dy): the pan added,
    the values scaled from coarse to native px per axis, then the fit's
    coarse coords moved to the native (h, w) grid's coords."""
    A = A.clone()
    A[:, 0, 2] += t[:, 0].float()
    A[:, 1, 2] += t[:, 1].float()
    sx = hw[1] / coarse_hw[1]
    sy = hw[0] / coarse_hw[0]
    A = A * device_constant(("camera_scale", sx, sy), lambda: np.float32([sx, sy]),
                            A.device)[:, None]
    return affine_to_native_coords(A, sx, sy)


def affine_to_warp(A: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Background-motion affine -> the source-coordinate affine of
    warp.warp_affine: src = [x, y] + A @ [x, y, 1]."""
    return A + device_constant("affine_identity",
                               lambda: np.float32([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
                               A.device)


def lk_affine(c0: torch.Tensor, c1: torch.Tensor, warp_fn=None, n_iters: int = 8,
              huber_delta: float = 3.0) -> torch.Tensor:
    """Direct affine alignment (Lucas-Kanade) of one pre-translated pair, c0
    and c1 f32 [H, W]: Gauss-Newton on the intensities with c0's gradients
    and a Huber weight at huber_delta x the median residual (of the whole
    field). warp_fn(img, u, v) warps one image by +(u, v); by default a
    border-clamped bilinear sample. Returns A [2, 3] with u(x, y) = A @
    [x, y, 1] in this grid's pixel coordinates."""
    h, w = c0.shape
    xn, yn, sxn, syn = _normalized_grid(h, w, c0.device)
    gy, gx = torch.gradient(c0)
    sd = torch.stack([gx * xn, gx * yn, gx, gy * xn, gy * yn, gy])   # [6, H, W]
    if warp_fn is None:
        ys, xs = pixel_grid(h, w, c0.device)

        def warp_fn(img, u, v):
            return bilinear_sample(img[None], ys + v, xs + u)[0]

    eye = 1e-6 * torch.eye(6, dtype=torch.float32, device=c0.device)
    p = torch.zeros(6, dtype=torch.float32, device=c0.device)
    for _ in range(n_iters):
        u = p[0] * xn + p[1] * yn + p[2]
        v = p[3] * xn + p[4] * yn + p[5]
        r = warp_fn(c1, u, v) - c0
        absr = r.abs()
        thresh = huber_delta * median_midpoint(absr.reshape(-1)) + 1e-6
        wgt = torch.clamp(thresh / (absr + 1e-8), max=1.0)
        sw = sd * wgt
        hess = torch.einsum("ihw,jhw->ij", sw, sd) + eye
        b = torch.einsum("ihw,hw->i", sw, r)
        p = p - _solve(hess, b)
    return torch.stack([
        torch.stack([p[0] * sxn, p[1] * syn, p[2] - p[0] - p[1]]),
        torch.stack([p[3] * sxn, p[4] * syn, p[5] - p[3] - p[4]]),
    ])


def lk_affine_batch(c0: torch.Tensor, c1: torch.Tensor, warp_fn: WarpFn,
                    n_iters: int = 8, huber_delta: float = 3.0) -> torch.Tensor:
    """Batched direct affine alignment of c1 (pre-translated) onto c0, both
    f32 [N, H, W]; warp_fn(img, u, v) warps a batch by +(u, v). Returns A
    [N, 2, 3] with u(x, y) = A @ [x, y, 1] in this grid's pixel coords."""
    n, h, w = c0.shape
    xn, yn, sxn, syn = _normalized_grid(h, w, c0.device)
    gy = torch.gradient(c0, dim=1)[0]
    gx = torch.gradient(c0, dim=2)[0]
    sd = torch.stack([gx * xn, gx * yn, gx, gy * xn, gy * yn, gy], dim=1)  # [N, 6, H, W]
    eye = 1e-6 * torch.eye(6, dtype=torch.float32, device=c0.device)
    p = torch.zeros((n, 6), dtype=torch.float32, device=c0.device)
    for _ in range(n_iters):
        pp = p[:, :, None, None]
        u = pp[:, 0] * xn + pp[:, 1] * yn + pp[:, 2]
        v = pp[:, 3] * xn + pp[:, 4] * yn + pp[:, 5]
        r = warp_fn(c1, u.contiguous(), v.contiguous()) - c0
        absr = r.abs()
        # the residuals' scale from a 2x2-strided subsample, as the JAX
        # package takes it
        med = median_midpoint(absr[:, ::2, ::2].reshape(n, -1))
        thresh = huber_delta * med[:, None, None] + 1e-6
        wgt = torch.clamp(thresh / (absr + 1e-8), max=1.0)
        sw = sd * wgt[:, None]
        hess = torch.einsum("nihw,njhw->nij", sw, sd) + eye
        b = torch.einsum("nihw,nhw->ni", sw, r)
        p = p - _solve(hess, b[..., None])[..., 0]
    return torch.stack([
        torch.stack([p[:, 0] * sxn, p[:, 1] * syn, p[:, 2] - p[:, 0] - p[:, 1]], dim=1),
        torch.stack([p[:, 3] * sxn, p[:, 4] * syn, p[:, 5] - p[:, 3] - p[:, 4]], dim=1),
    ], dim=1)


def homography_params(hn: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] normalized homography (H22 == 1) -> its 8 parameters."""
    return torch.stack([
        hn[..., 0, 0] - 1.0, hn[..., 0, 1], hn[..., 0, 2],
        hn[..., 1, 0], hn[..., 1, 1] - 1.0, hn[..., 1, 2],
        hn[..., 2, 0], hn[..., 2, 1],
    ], dim=-1)


def lk_homography_batch(c0: torch.Tensor, c1: torch.Tensor, warp_fn: WarpFn,
                        n_iters: int = 8, huber_delta: float = 3.0,
                        p0: torch.Tensor | None = None) -> torch.Tensor:
    """Batched direct homography alignment of c1 (pre-translated) onto c0,
    both f32 [N, H, W]; warp_fn(img, u, v) warps a batch by +(u, v). p0
    [N, 8] warm-starts the parameters. Returns Hn [N, 3, 3]:
        [xs, ys, s] = Hn @ [xn, yn, 1],  src_n = (xs/s, ys/s)."""
    n, h, w = c0.shape
    xn, yn, sxn, syn = _normalized_grid(h, w, c0.device)
    gy = torch.gradient(c0, dim=1)[0]
    gx = torch.gradient(c0, dim=2)[0]
    gxp = gx / sxn
    gyp = gy / syn
    sd = torch.stack([
        gxp * xn, gxp * yn, gxp,
        gyp * xn, gyp * yn, gyp,
        -(gxp * xn * xn + gyp * xn * yn),
        -(gxp * xn * yn + gyp * yn * yn),
    ], dim=1)                                             # [N, 8, H, W]
    eye = 1e-6 * torch.eye(8, dtype=torch.float32, device=c0.device)

    def disp(p):
        pp = p[:, :, None, None]
        num_x = (1.0 + pp[:, 0]) * xn + pp[:, 1] * yn + pp[:, 2]
        num_y = pp[:, 3] * xn + (1.0 + pp[:, 4]) * yn + pp[:, 5]
        den = pp[:, 6] * xn + pp[:, 7] * yn + 1.0
        return (num_x / den - xn) / sxn, (num_y / den - yn) / syn

    p = (torch.zeros((n, 8), dtype=torch.float32, device=c0.device)
         if p0 is None else p0)
    for _ in range(n_iters):
        u, v = disp(p)
        r = warp_fn(c1, u.contiguous(), v.contiguous()) - c0
        absr = r.abs()
        med = median_midpoint(absr[:, ::2, ::2].reshape(n, -1))
        thresh = huber_delta * med[:, None, None] + 1e-6
        wgt = torch.clamp(thresh / (absr + 1e-8), max=1.0)
        sw = sd * wgt[:, None]
        hess = torch.einsum("nihw,njhw->nij", sw, sd) + eye
        b = torch.einsum("nihw,nhw->ni", sw, r)
        p = p - _solve(hess, b[..., None])[..., 0]
    one = torch.ones_like(p[:, 0])
    return torch.stack([
        torch.stack([1.0 + p[:, 0], p[:, 1], p[:, 2]], dim=1),
        torch.stack([p[:, 3], 1.0 + p[:, 4], p[:, 5]], dim=1),
        torch.stack([p[:, 6], p[:, 7], one], dim=1),
    ], dim=1)


def homography_translate(hn: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                         w: int, h: int) -> torch.Tensor:
    """Compose a pixel translation (applied after the homography) into hn:
    a constant shift adds t_n * denominator to the numerator rows."""
    txn = tx * (2.0 / w)
    tyn = ty * (2.0 / h)
    row0 = hn[..., 0, :] + txn[..., None] * hn[..., 2, :]
    row1 = hn[..., 1, :] + tyn[..., None] * hn[..., 2, :]
    return torch.stack([row0, row1, hn[..., 2, :]], dim=-2)


def homography_displacement(hn: torch.Tensor, h: int, w: int):
    """Pixel displacement fields (u, v) [..., h, w] of normalized-coords
    homographies hn [..., 3, 3] on an (h, w) grid."""
    xn, yn, sxn, syn = _normalized_grid(h, w, hn.device)
    H = hn[..., None, None]                               # [..., 3, 3, 1, 1]
    num_x = H[..., 0, 0, :, :] * xn + H[..., 0, 1, :, :] * yn + H[..., 0, 2, :, :]
    num_y = H[..., 1, 0, :, :] * xn + H[..., 1, 1, :, :] * yn + H[..., 1, 2, :, :]
    den = H[..., 2, 0, :, :] * xn + H[..., 2, 1, :, :] * yn + H[..., 2, 2, :, :]
    return (num_x / den - xn) / sxn, (num_y / den - yn) / syn
