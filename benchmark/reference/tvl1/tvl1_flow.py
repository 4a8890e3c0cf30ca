# A frozen copy of videoquery_torch/kernels/tvl1_flow.py (its plain versions only), for the
# benchmark's reference; it imports nothing of the program.
"""Pyramidal warped TV-L1 flow on K2 and K3.

Port of the host half of ``videoquery/kernels/tvl1_pallas.py``: the pyramid
(``tvl1_flow_pallas``), the warm-started finest-level refinement
(``tvl1_flow_pallas_warm``), the camera (estimate, refine, apply; an
affine A [N, 2, 3] or a homography Hn [N, 3, 3], as
``TVL1Params.camera_model`` says) and the warped variants. Every pyramid
level runs on K2 (``kernels/tvl1_level.py``) and every warp of the camera
path on K3 (``kernels/window_warp.py``): a CUDA tensor launches the
kernels, a CPU tensor takes their plain versions. Resizes are JAX's linear
resize (``kernels/resize.py``). The window shrinks with pyramid scale:
d = max(2, round(max_disp * scale_step**level)).

``kernels/tvl1.py`` has functions of the same names (``tvl1_flow``,
``tvl1_warped_flow``): the gather-warp baseline, as the JAX package has
``tvl1.py`` beside ``tvl1_pallas.py``.
"""

from __future__ import annotations

import torch

from benchmark.reference.tvl1.motion import (affine_camera,
                                             global_translation,
                                             homography_displacement,
                                             homography_params,
                                             homography_translate,
                                             lk_affine_batch,
                                             lk_homography_batch)
from benchmark.reference.tvl1.resize import resize2
from benchmark.reference.tvl1.tvl1 import TVL1Params, _pyramid_shapes
from benchmark.reference.tvl1.tvl1_level import tvl1_level
from benchmark.reference.tvl1.warp import pixel_grid, roll_pairs
from benchmark.reference.tvl1.window_warp import window_warp


def _level_disp(max_disp: int, p: TVL1Params, level: int) -> int:
    return max(2, round(max_disp * p.scale_step ** level))


def _solve_pyramid(pyr0, pyr1, u, v, p: TVL1Params, max_disp: int):
    """Coarse to fine over the given pyramid, from (u, v) at its coarsest
    level."""
    for i in reversed(range(len(pyr0))):
        u, v = tvl1_level(pyr0[i], pyr1[i], u, v, p.at_level(i),
                          _level_disp(max_disp, p, i))
        if i > 0:
            inv = 1.0 / p.scale_step
            hw = pyr0[i - 1].shape[-2:]
            u = (resize2(u, hw) * inv).contiguous()
            v = (resize2(v, hw) * inv).contiguous()
    return u, v


def _pyramid(img: torch.Tensor, shapes) -> list[torch.Tensor]:
    pyr = [img]
    for hw in shapes[1:]:
        pyr.append(resize2(pyr[-1], hw).contiguous())
    return pyr


def tvl1_flow(i0: torch.Tensor, i1: torch.Tensor, p: TVL1Params = TVL1Params(),
              max_disp: int = 6) -> tuple[torch.Tensor, torch.Tensor]:
    """Full pyramidal TV-L1: i0, i1 f32 [N, H, W] in [0, 1] -> (u, v)."""
    shapes = _pyramid_shapes(i0.shape[1], i0.shape[2], p)
    z = torch.zeros((i0.shape[0],) + shapes[-1], dtype=torch.float32,
                    device=i0.device)
    return _solve_pyramid(_pyramid(i0, shapes), _pyramid(i1, shapes), z, z,
                          p, max_disp)


def tvl1_flow_warm(i0, i1, u0, v0, p: TVL1Params = TVL1Params(),
                   max_disp: int = 6, levels: int = 1):
    """Warm-started TV-L1: refine (u0, v0) over the finest `levels` levels."""
    shapes = _pyramid_shapes(i0.shape[1], i0.shape[2], p)[:levels]
    scale = p.scale_step ** (len(shapes) - 1)
    u = (resize2(u0, shapes[-1]) * scale).contiguous()
    v = (resize2(v0, shapes[-1]) * scale).contiguous()
    return _solve_pyramid(_pyramid(i0, shapes), _pyramid(i1, shapes), u, v,
                          p, max_disp)


def rollwindow_warp_fields(img, du, dv, d: int = 4):
    """Warp img by displacement fields of any size: an integer per-pair roll
    by the field's centre value, then the window warp (K3) for the
    residual, which must stay within +-d."""
    h, w = du.shape[1:]
    tx = torch.round(du[:, h // 2, w // 2])
    ty = torch.round(dv[:, h // 2, w // 2])
    rolled = roll_pairs(img, tx, ty)
    return window_warp(rolled, (du - tx[:, None, None]).contiguous(),
                       (dv - ty[:, None, None]).contiguous(), d)


def _affine_warp_rollwindow(img: torch.Tensor, A: torch.Tensor, d: int = 4) -> torch.Tensor:
    """Warp img [N, H, W] by displacement affines A [N, 2, 3]
    (src = [x, y] + A @ [x, y, 1]): an integer per-pair roll by the
    displacement at the frame's centre, then K3 for the residual (zoom and
    rotation), which must stay within +-d. The roll is circular: the wrapped
    band, at most |t| wide, touches only the frame's edges."""
    n, h, w = img.shape
    ys, xs = pixel_grid(h, w, img.device)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    t = torch.round(torch.stack([A[:, 0, 0] * cx + A[:, 0, 1] * cy + A[:, 0, 2],
                                 A[:, 1, 0] * cx + A[:, 1, 1] * cy + A[:, 1, 2]], 1))
    rolled = roll_pairs(img, t[:, 0], t[:, 1])
    a = A[:, :, :, None, None]
    du = (a[:, 0, 0] * xs + a[:, 0, 1] * ys + a[:, 0, 2]) - t[:, 0, None, None]
    dv = (a[:, 1, 0] * xs + a[:, 1, 1] * ys + a[:, 1, 2]) - t[:, 1, None, None]
    return window_warp(rolled, du.contiguous(), dv.contiguous(), d)


def estimate_camera(i0, i1, p: TVL1Params) -> torch.Tensor:
    """Per-pair camera motion: integer pan from the cross-correlation on the
    coarse grid p.coarse_hw, then 6 LK iterations on the pan-compensated
    pair (warps on K3, d=4). p.camera_model "homography" gives Hn
    [N, 3, 3] in normalized coords; "affine" gives the displacement affine
    A [N, 2, 3] in i0's native pixel coords."""
    coarse_hw = p.coarse_hw
    c0 = resize2(i0, coarse_hw).contiguous()
    c1 = resize2(i1, coarse_hw).contiguous()
    t = global_translation(c0, c1, max_shift=12)          # int32 [N, 2] (u, v)
    c1t = roll_pairs(c1, t[:, 0], t[:, 1])

    def warp_fn(img, u, v):
        return window_warp(img, u, v, 4)

    if p.camera_model == "homography":
        hn = lk_homography_batch(c0, c1t, warp_fn, n_iters=6)
        return homography_translate(hn, t[:, 0].float(), t[:, 1].float(),
                                    coarse_hw[1], coarse_hw[0])
    return affine_camera(lk_affine_batch(c0, c1t, warp_fn, n_iters=6), t,
                         tuple(i0.shape[1:]), coarse_hw)


def refine_camera(i0, i1, p: TVL1Params, hn0: torch.Tensor,
                  n_iters: int = 3) -> torch.Tensor:
    """Refine a neighbour pair's homography hn0 on this pair: LK warm-started
    at hn0, warps by roll + window (so large pans stay in the window).
    Homographies only, as in the JAX package."""
    c0 = resize2(i0, p.coarse_hw).contiguous()
    c1 = resize2(i1, p.coarse_hw).contiguous()
    return lk_homography_batch(c0, c1, rollwindow_warp_fields, n_iters=n_iters,
                               p0=homography_params(hn0))


def apply_camera(i1: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Warp i1 by the camera (roll + window warp, d=4): cam [N, 3, 3] is a
    normalized-coords homography, [N, 2, 3] a displacement affine."""
    if cam.shape[-2] == 2:
        return _affine_warp_rollwindow(i1, cam, 4)
    h, w = i1.shape[1:]
    du, dv = homography_displacement(cam, h, w)
    return rollwindow_warp_fields(i1, du, dv, 4)


def tvl1_warped_flow(i0, i1, p: TVL1Params = TVL1Params(), max_disp: int = 6):
    """Camera-compensated TV-L1 (dense_flow's extract_warp_gpu structure)."""
    return tvl1_flow(i0, apply_camera(i1, estimate_camera(i0, i1, p)), p, max_disp)


def tvl1_warped_flow_cam(i0, i1, p: TVL1Params = TVL1Params(), max_disp: int = 6):
    """tvl1_warped_flow that also returns the per-pair camera (A [N, 2, 3]
    or Hn [N, 3, 3])."""
    cam = estimate_camera(i0, i1, p)
    u, v = tvl1_flow(i0, apply_camera(i1, cam), p, max_disp)
    return u, v, cam


def tvl1_warped_flow_warm(i0, i1, u0, v0, p: TVL1Params = TVL1Params(),
                          max_disp: int = 6, levels: int = 1,
                          cam: torch.Tensor | None = None,
                          cam_refine_iters: int = 0):
    """Warm-started warped flow. Without cam each pair estimates its own
    camera; with cam (the key pair's) it is reused, and a homography is
    refined on this pair with cam_refine_iters LK iterations (an affine is
    reused as it is, as in the JAX package)."""
    if cam is None:
        cam = estimate_camera(i0, i1, p)
    elif cam_refine_iters > 0 and cam.shape[-2] == 3:
        cam = refine_camera(i0, i1, p, cam, n_iters=cam_refine_iters)
    return tvl1_flow_warm(i0, apply_camera(i1, cam), u0, v0, p, max_disp, levels)
