"""Pyramidal TV-L1 optical flow with gather warps: the flow-quality baseline.

Port of ``videoquery/kernels/tvl1.py``: ``TVL1Params`` (the comments there
say why each default was chosen), the pyramid geometry, and the JAX
package's gather-warp solver, ``tvl1_flow`` and ``tvl1_warped_flow``. The
solver runs as batched tensors: each ``lax.scan`` of the JAX package is a
Python loop of whole-batch operations; warps are the exact bilinear
gathers of ``kernels/warp.py`` at full resolution, with no window clamp.
It is the faithful baseline of ``tools/flow_quality.py`` and what
``flow_impl="xla"`` runs; nothing picks it by default.

The production flow, with the same function names, is
``kernels/tvl1_flow.py``: the level kernel K2 and the window-warp kernel
K3 (as the JAX package has ``tvl1.py`` and ``tvl1_pallas.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from videoquery_torch.kernels.motion import (affine_camera, affine_to_warp,
                                             global_translation, homography_displacement,
                                             homography_translate, lk_affine_batch,
                                             lk_homography_batch)
from videoquery_torch.kernels.resize import resize2
from videoquery_torch.kernels.warp import (bilinear_sample, bilinear_warp, pixel_grid,
                                           roll_pairs, warp_affine)


@dataclasses.dataclass(frozen=True)
class TVL1Params:
    tau: float = 0.25           # dual time step
    lambda_: float = 38.25      # data weight for [0, 1] intensities (0.15 x 255)
    theta: float = 0.3          # tightness
    n_scales: int = 5
    n_warps: int = 5
    n_iters: int = 30           # primal-dual iterations per warp
    scale_step: float = 0.5
    grad_eps: float = 1e-6
    fine_warps: int | None = None   # warps at the finest 2 levels (None = n_warps)
    fine_iters: int | None = None   # iterations at the finest 2 levels
    warm_iters: int | None = None   # iterations of a warm pair's refinement
    warm_warps: int = 1             # warps of a warm pair's refinement
    # factorized window warp: a vertical then a horizontal 2-tap pass
    separable_warp: bool = True
    coarse_hw: tuple[int, int] = (48, 64)   # camera-estimation grid
    rescue_frac: float = 0.0        # fraction of pairs a rescue may re-solve
    rescue_trigger: float = 0.9     # pooled peak |flow| >= trigger * max_disp
    camera_model: str = "affine"    # "affine" (6 params) or "homography" (8)
    grad_source: str = "image"      # "image" | "warped" (separable only)

    def warps_at_level(self, level: int) -> int:
        if self.fine_warps is not None and level < 2:
            return min(self.n_warps, self.fine_warps)
        return self.n_warps

    def iters_at_level(self, level: int) -> int:
        if self.fine_iters is not None and level < 2:
            return min(self.n_iters, self.fine_iters)
        return self.n_iters

    def at_level(self, level: int) -> "TVL1Params":
        return dataclasses.replace(self, n_warps=self.warps_at_level(level),
                                   n_iters=self.iters_at_level(level))


def _pyramid_shapes(h: int, w: int, p: TVL1Params) -> list[tuple[int, int]]:
    shapes = [(h, w)]
    for _ in range(p.n_scales - 1):
        h = max(int(round(h * p.scale_step)), 16)
        w = max(int(round(w * p.scale_step)), 16)
        if (h, w) == shapes[-1]:
            break
        shapes.append((h, w))
    return shapes


def _forward_diff(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences of [N, H, W], zero at the far edge (Neumann)."""
    fx = torch.cat([f[..., 1:] - f[..., :-1], torch.zeros_like(f[..., :1])], dim=-1)
    fy = torch.cat([f[..., 1:, :] - f[..., :-1, :], torch.zeros_like(f[..., :1, :])], dim=-2)
    return fx, fy


def _divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Adjoint of -forward_diff: backward differences, the first element
    kept and the last negated."""
    d1 = torch.cat([p1[..., :1], p1[..., 1:-1] - p1[..., :-2], -p1[..., -2:-1]], dim=-1)
    d2 = torch.cat([p2[..., :1, :], p2[..., 1:-1, :] - p2[..., :-2, :], -p2[..., -2:-1, :]],
                   dim=-2)
    return d1 + d2


def _centered_grad(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Centred gradients of [N, H, W], one-sided at the borders."""
    gx = (torch.roll(img, -1, -1) - torch.roll(img, 1, -1)) * 0.5
    gx[..., 0] = img[..., 1] - img[..., 0]
    gx[..., -1] = img[..., -1] - img[..., -2]
    gy = (torch.roll(img, -1, -2) - torch.roll(img, 1, -2)) * 0.5
    gy[..., 0, :] = img[..., 1, :] - img[..., 0, :]
    gy[..., -1, :] = img[..., -1, :] - img[..., -2, :]
    return gx, gy


def _tvl1_level(i0, i1, u, v, p: TVL1Params):
    """One pyramid level: n_warps x n_iters primal-dual updates of a batch,
    all [N, H, W]; returns the updated (u, v)."""
    ys, xs = pixel_grid(i0.shape[1], i0.shape[2], i0.device)
    i1x, i1y = _centered_grad(i1)
    l_t = p.lambda_ * p.theta
    taut = p.tau / p.theta
    q11 = q12 = q21 = q22 = torch.zeros_like(u)
    for _ in range(p.n_warps):
        # warp I1 and its gradient by the current flow estimate
        wy, wx = ys + v, xs + u
        i1w = bilinear_sample(i1, wy, wx)
        i1wx = bilinear_sample(i1x, wy, wx)
        i1wy = bilinear_sample(i1y, wy, wx)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u - i1wy * v - i0
        th = l_t * grad
        rgrad = torch.clamp(grad, min=p.grad_eps)
        for _ in range(p.n_iters):
            rho = rho_c + i1wx * u + i1wy * v
            # soft thresholding of the data term
            d_lt = torch.where(rho < -th, l_t, 0.0)
            d_gt = torch.where(rho > th, -l_t, 0.0)
            mid = torch.where((rho >= -th) & (rho <= th), -rho / rgrad, 0.0)
            step = d_lt + d_gt + mid
            u1 = u + step * i1wx
            v1 = v + step * i1wy
            # primal update with the divergence of the dual field
            u = u1 + p.theta * _divergence(q11, q12)
            v = v1 + p.theta * _divergence(q21, q22)
            # dual ascent
            ux, uy = _forward_diff(u)
            vx, vy = _forward_diff(v)
            gu = torch.sqrt(ux * ux + uy * uy)
            gv = torch.sqrt(vx * vx + vy * vy)
            q11 = (q11 + taut * ux) / (1.0 + taut * gu)
            q12 = (q12 + taut * uy) / (1.0 + taut * gu)
            q21 = (q21 + taut * vx) / (1.0 + taut * gv)
            q22 = (q22 + taut * vy) / (1.0 + taut * gv)
    return u, v


def tvl1_flow(i0: torch.Tensor, i1: torch.Tensor, params: TVL1Params = TVL1Params()
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched pyramidal TV-L1 (the JAX package's _tvl1_single over a
    batch): i0, i1 f32 [N, H, W] in [0, 1] -> (u, v) in pixels."""
    shapes = _pyramid_shapes(i0.shape[1], i0.shape[2], params)
    pyr0, pyr1 = [i0], [i1]
    for hw in shapes[1:]:
        pyr0.append(resize2(pyr0[-1], hw))
        pyr1.append(resize2(pyr1[-1], hw))
    u = torch.zeros((i0.shape[0],) + shapes[-1], dtype=torch.float32, device=i0.device)
    v = torch.zeros_like(u)
    for i in reversed(range(len(shapes))):
        u, v = _tvl1_level(pyr0[i], pyr1[i], u, v, params.at_level(i))
        if i > 0:
            inv = 1.0 / params.scale_step
            u = resize2(u, shapes[i - 1]) * inv
            v = resize2(v, shapes[i - 1]) * inv
    return u, v


def tvl1_warped_flow(i0: torch.Tensor, i1: torch.Tensor, params: TVL1Params = TVL1Params(),
                     coarse_hw: tuple[int, int] = (64, 96)
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-compensated TV-L1 (dense_flow's extract_warp_gpu structure):
    the integer pan from the cross-correlation on the coarse grid
    ``coarse_hw`` (its own default, not params.coarse_hw, as in the JAX
    package), 6 LK iterations of params.camera_model on the pan-compensated
    coarse pair, i1 warped by the camera with a bilinear gather, then the
    pyramid. Returns the residual (foreground) flow."""
    c0 = resize2(i0, coarse_hw)
    c1 = resize2(i1, coarse_hw)
    t = global_translation(c0, c1, max_shift=12)
    c1t = roll_pairs(c1, t[:, 0], t[:, 1])
    h, w = i0.shape[1:]
    if params.camera_model == "homography":
        hn = lk_homography_batch(c0, c1t, bilinear_warp, n_iters=6)
        hn = homography_translate(hn, t[:, 0].float(), t[:, 1].float(),
                                  coarse_hw[1], coarse_hw[0])
        du, dv = homography_displacement(hn, h, w)
        return tvl1_flow(i0, bilinear_warp(i1, du, dv), params)
    A = affine_camera(lk_affine_batch(c0, c1t, bilinear_warp, n_iters=6), t, (h, w),
                      coarse_hw)
    return tvl1_flow(i0, warp_affine(i1, affine_to_warp(A, h, w)), params)
