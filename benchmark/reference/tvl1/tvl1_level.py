# A frozen copy of videoquery_torch/kernels/tvl1_level.py (its plain versions only), for the
# benchmark's reference; it imports nothing of the program.
"""One TV-L1 pyramid level for a batch of pairs, plain PyTorch: for each
of ``p.n_warps`` warps, clamp the flow to +-max_disp, warp I1, linearise,
then ``p.n_iters`` primal-dual steps, on the TPU kernels' padded domain
(planes edge-padded to multiples of (8, 128), I1 padded by max_disp + 1 and
read modulo its padded size), as the program computes it."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.tvl1.tvl1 import TVL1Params
from benchmark.reference.tvl1.window_warp import (PaddedGeometry, edge_pad,
                                                  full_warp, hpass, vpass)

MODE_WARPED, MODE_IMAGE, MODE_FULL = 0, 1, 2


def warp_mode(p: TVL1Params) -> int:
    if not p.separable_warp:
        return MODE_FULL
    return MODE_WARPED if p.grad_source == "warped" else MODE_IMAGE


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak constant."""
    return float(np.float32(x))


def _constants(p: TVL1Params) -> tuple[float, float, float, float]:
    return (_f32(p.lambda_ * p.theta), _f32(p.tau / p.theta), _f32(p.theta),
            _f32(p.grad_eps))


def centered_grad(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Centred spatial gradients of [N, H, W], one-sided at the borders
    (tvl1_pallas._centered_grad_batch)."""
    gx = (torch.cat([img[:, :, 1:], img[:, :, -1:]], 2)
          - torch.cat([img[:, :, :1], img[:, :, :-1]], 2))
    gy = (torch.cat([img[:, 1:], img[:, -1:]], 1)
          - torch.cat([img[:, :1], img[:, :-1]], 1))
    h, w = img.shape[1:]
    col = torch.arange(w, device=img.device)
    row = torch.arange(h, device=img.device)[:, None]
    gx = torch.where((col > 0) & (col < w - 1), gx * 0.5, gx)
    gy = torch.where((row > 0) & (row < h - 1), gy * 0.5, gy)
    return gx, gy


# -- plain PyTorch version ----------------------------------------------------

def _forward_diff(f):
    z = torch.zeros_like(f)
    fx = torch.cat([f[..., 1:] - f[..., :-1], z[..., :1]], -1)
    fy = torch.cat([f[..., 1:, :] - f[..., :-1, :], z[..., :1, :]], -2)
    return fx, fy


def _divergence(p1, p2):
    d1 = torch.cat([p1[..., :1], p1[..., 1:-1] - p1[..., :-2],
                    -p1[..., -2:-1]], -1)
    d2 = torch.cat([p2[..., :1, :], p2[..., 1:-1, :] - p2[..., :-2, :],
                    -p2[..., -2:-1, :]], -2)
    return d1 + d2


def _grad_padded(x):
    """Centred differences with one-sided borders over the whole padded
    plane (the TPU kernel's _grad_inkernel)."""
    xr = torch.roll(x, -1, 2)
    xl = torch.roll(x, 1, 2)
    col = torch.arange(x.shape[2], device=x.device)
    gx = torch.where(col == 0, xr - x,
                     torch.where(col == x.shape[2] - 1, x - xl, (xr - xl) * 0.5))
    xd = torch.roll(x, -1, 1)
    xu = torch.roll(x, 1, 1)
    row = torch.arange(x.shape[1], device=x.device)[:, None]
    gy = torch.where(row == 0, xd - x,
                     torch.where(row == x.shape[1] - 1, x - xu, (xd - xu) * 0.5))
    return gx, gy


def tvl1_level_reference(i0, i1, u, v, p: TVL1Params = TVL1Params(),
                         max_disp: int = 6):
    """Plain version of tvl1_level (same arguments and results)."""
    n, h, w = i0.shape
    d = max_disp
    g = PaddedGeometry(h, w, d)
    mode = warp_mode(p)
    l_t, taut, theta, eps = _constants(p)
    i0p = edge_pad(i0, g.hp, g.wp)
    up = edge_pad(u, g.hp, g.wp)
    vp = edge_pad(v, g.hp, g.wp)
    wins = [edge_pad(i1, g.hh, g.ww, g.pad, g.pad)]
    if mode != MODE_WARPED:
        wins += [edge_pad(x, g.hh, g.ww, g.pad, g.pad) for x in centered_grad(i1)]
    q11 = torch.zeros_like(up)
    q12, q21, q22 = (torch.zeros_like(up) for _ in range(3))
    for _warp in range(p.n_warps):
        up = up.clamp(-d, d)
        vp = vp.clamp(-d, d)
        if mode == MODE_FULL:
            i1w, ix, iy = (full_warp(x, up, vp, d) for x in wins)
        elif mode == MODE_IMAGE:
            i1w, ix, iy = (hpass(vpass(x, vp, d), up, d) for x in wins)
        else:
            i1w = hpass(vpass(wins[0], vp, d), up, d)
            ix, iy = _grad_padded(i1w)
        grad = ix * ix + iy * iy
        rho_c = i1w - ix * up - iy * vp - i0p
        rgrad = 1.0 / torch.clamp(grad, min=eps)
        for _ in range(p.n_iters):
            rho = rho_c + ix * up + iy * vp
            step = torch.clamp(-rho * rgrad, -l_t, l_t)
            u1 = up + step * ix
            v1 = vp + step * iy
            up = u1 + theta * _divergence(q11, q12)
            vp = v1 + theta * _divergence(q21, q22)
            ux, uy = _forward_diff(up)
            vx, vy = _forward_diff(vp)
            ru = 1.0 / (1.0 + taut * torch.sqrt(ux * ux + uy * uy))
            rv = 1.0 / (1.0 + taut * torch.sqrt(vx * vx + vy * vy))
            q11 = (q11 + taut * ux) * ru
            q12 = (q12 + taut * uy) * ru
            q21 = (q21 + taut * vx) * rv
            q22 = (q22 + taut * vy) * rv
    return up[:, :h, :w].contiguous(), vp[:, :h, :w].contiguous()


# -- the kernel ---------------------------------------------------------------


def tvl1_level(i0, i1, u, v, p: TVL1Params = TVL1Params(), max_disp: int = 6):
    """One TV-L1 level: i0, i1, u, v f32 [N, H, W] -> updated (u, v) (the
    plain version)."""
    return tvl1_level_reference(i0, i1, u, v, p, max_disp)
