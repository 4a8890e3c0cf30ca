"""Global (camera) motion for warped optical flow.

Port of the homography half of ``videoquery/kernels/motion.py``: the
integer pan of a pair from one grouped cross-correlation, and a direct
8-parameter homography fit (Gauss-Newton on intensities, Lucas-Kanade)
with a pluggable batched warp. Homographies are in normalized coordinates
(xn = 2x/W - 1), so one fit applies on any grid of the same field of view.
The affine model (``lk_affine_batch``, ``estimate_affine``) is not
production and is not ported.

Numbers: the cross-correlation is a convolution and its argmax moves under
TF32, so callers turn TF32 off (the extractor does); ``jnp.median`` of an
even count is the mean of the two middle values, which ``median_midpoint``
reproduces (``torch.median`` returns the lower one).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

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
        p = p - torch.linalg.solve(hess, b[..., None])[..., 0]
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
