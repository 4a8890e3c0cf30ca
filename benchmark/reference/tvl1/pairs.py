# A frozen copy of videoquery_torch/pipeline/extract.py's pair path (the
# plain versions; the fast-motion rescue decided at once, as prepare_step
# does), for the benchmark's reference; it imports nothing of the program.
"""The flow of a batch's pairs and the networks' inputs, plain PyTorch.

``prepare(frames_u8, cfg, tvl1, dtype)`` is the port's ``prepare_step`` for
the production path (device gray at the flow grid, the selected pairs'
warped TV-L1 with the warm plan, the rescue, the quantized stacks and the
preprocess): (rgb [B, T, crop, crop, 3], flow [B, T, crop, crop, 10]).
``gray_operands`` rounds the gray matmul's operands (the port rounds them
to bf16 on an accelerator; the reference keeps f32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.tvl1._const import device_constant
from benchmark.reference.tvl1.preprocess import (preprocess_flow, preprocess_rgb,
                                                 quantize_flow)
from benchmark.reference.tvl1.resize import linear_matrix, resize2
from benchmark.reference.tvl1.sampling import (flow_pair_plan, flow_warm_plan,
                                               frame_ticks)
from benchmark.reference.tvl1.tvl1 import TVL1Params
from benchmark.reference.tvl1.tvl1_flow import (tvl1_flow, tvl1_flow_warm,
                                                tvl1_warped_flow,
                                                tvl1_warped_flow_cam,
                                                tvl1_warped_flow_warm)
from benchmark.reference.tvl1.window_warp import window_warp


def flow_grid_shape(h0: int, w0: int, flow_res_div: int) -> tuple[int, int]:
    """(fh, fw) of the reduced flow grid (pipeline/payload.py)."""
    if flow_res_div <= 1:
        return h0, w0
    fh = max(8, (h0 // flow_res_div) // 8 * 8)
    fw0 = w0 // flow_res_div
    fw = (fw0 // 128 * 128) if fw0 >= 128 else fw0
    return fh, fw


PRODUCTION_TVL1 = TVL1Params(n_scales=4, n_warps=3, fine_warps=2,
                             n_iters=20, fine_iters=10, warm_iters=6,
                             grad_source="warped",
                             camera_model="homography",
                             rescue_frac=0.125)


def warm_tvl1_params(tvl1: TVL1Params) -> TVL1Params:
    """Refinement schedule of warm-started pairs: warm_warps passes at
    warm_iters (else the fine or the coarse) iterations."""
    return dataclasses.replace(
        tvl1, n_warps=tvl1.warm_warps, fine_warps=tvl1.warm_warps,
        fine_iters=None,
        n_iters=tvl1.warm_iters or tvl1.fine_iters or tvl1.n_iters)


def _solve_pairs(gray: torch.Tensor, pair_idx: torch.Tensor, warped: bool,
                 tvl1: TVL1Params, warm_plan=None, warm_camera: str = "own",
                 warm_advect: int = 0):
    """The selected pairs' images and flow before the rescue: (i0, i1, u, v),
    each f32 [B * P, h, w], pairs clip-major (_pair_flow_uv)."""
    b, f, h, w = gray.shape
    i0 = gray[:, pair_idx]
    i1 = gray[:, pair_idx + 1]
    p = pair_idx.shape[0]
    i0f = i0.reshape(b * p, h, w)
    i1f = i1.reshape(b * p, h, w)
    flow_fn = tvl1_warped_flow if warped else tvl1_flow
    if warm_plan is None or warm_plan[1].shape[0] == 0:
        u, v = flow_fn(i0f, i1f, tvl1)
        return i0f, i1f, u, v

    key_pos, warm_pos, warm_src = warm_plan
    k = key_pos.shape[0]
    m = warm_pos.shape[0]
    i0k = i0[:, key_pos].reshape(b * k, h, w)
    i1k = i1[:, key_pos].reshape(b * k, h, w)
    cam_warm = None
    if warped and warm_camera in ("key", "init"):
        uk, vk, ck = tvl1_warped_flow_cam(i0k, i1k, tvl1)
        cam_shape = tuple(ck.shape[1:])     # (2, 3) affine or (3, 3) homography
        cam_warm = ck.reshape((b, k) + cam_shape)[:, warm_src].reshape((b * m,) + cam_shape)
    else:
        uk, vk = flow_fn(i0k, i1k, tvl1)
    uk = uk.reshape(b, k, h, w)
    vk = vk.reshape(b, k, h, w)
    u0 = uk[:, warm_src].reshape(b * m, h, w)
    v0 = vk[:, warm_src].reshape(b * m, h, w)
    if warm_advect:
        # signed frame distance warm pair -> key, [b * m] b-major like u0
        j = (pair_idx[warm_pos] - pair_idx[key_pos][warm_src]).float()
        jb = j.repeat(b)[:, None, None]
        du = -jb * u0
        dv = -jb * v0
        uv0 = window_warp(torch.cat([u0, v0]), torch.cat([du, du]), torch.cat([dv, dv]),
                          warm_advect)
        u0, v0 = uv0[:b * m], uv0[b * m:]
    i0w = i0[:, warm_pos].reshape(b * m, h, w)
    i1w = i1[:, warm_pos].reshape(b * m, h, w)
    if warped:
        uw, vw = tvl1_warped_flow_warm(
            i0w, i1w, u0, v0, warm_tvl1_params(tvl1), cam=cam_warm,
            cam_refine_iters=3 if warm_camera == "init" else 0)
    else:
        uw, vw = tvl1_flow_warm(i0w, i1w, u0, v0, warm_tvl1_params(tvl1))
    u = torch.zeros((b, p, h, w), dtype=torch.float32, device=gray.device)
    v = torch.zeros_like(u)
    u[:, key_pos] = uk
    u[:, warm_pos] = uw.reshape(b, m, h, w)
    v[:, key_pos] = vk
    v[:, warm_pos] = vw.reshape(b, m, h, w)
    return i0f, i1f, u.reshape(b * p, h, w), v.reshape(b * p, h, w)


def _quantize_pairs(u: torch.Tensor, v: torch.Tensor, bound: float,
                    value_scale: tuple[float, float]) -> torch.Tensor:
    """(u, v) f32 [B, P, h, w] in flow-grid pixels -> u8 [B, P, h, w, 2]
    quantized in native pixels (value_scale (sx, sy))."""
    uv = torch.stack([u * value_scale[0], v * value_scale[1]], dim=-1)
    return quantize_flow(uv, bound)


def _bf16_operands(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and widened back: a product of two such values
    is exact in f32, so an f32 matmul of them is a bf16 x bf16 -> f32 dot."""
    return x.to(torch.bfloat16).float()


def _flow_gray_grid(frames_u8: torch.Tensor, flow_res_div: int,
                    matmul: bool = True, operands=lambda x: x):
    """ITU-R 601 luma (BGR order, cv2 parity) at the flow grid. Returns
    (gray f32 [B, F, fh, fw], (value_scale_x, value_scale_y)).

    matmul=True folds the channel dot into the horizontal resize: two
    matmuls with JAX's linear-resize matrices, bf16 operands with f32
    accumulation on an accelerator and f32 operands on the CPU, as the JAX
    package does."""
    h0, w0 = frames_u8.shape[2:4]
    if flow_res_div <= 1 or not matmul:
        f32 = frames_u8.float()
        gray = (0.114 * f32[..., 0] + 0.587 * f32[..., 1]
                + 0.299 * f32[..., 2]) / 255.0
        if flow_res_div <= 1:
            return gray, (1.0, 1.0)
        fh, fw = flow_grid_shape(h0, w0, flow_res_div)
        return resize2(gray, (fh, fw)), (w0 / fw, h0 / fh)
    b, f = frames_u8.shape[:2]
    fh, fw = flow_grid_shape(h0, w0, flow_res_div)
    dev = frames_u8.device
    rv = device_constant(("linear", h0, fh), lambda: linear_matrix(h0, fh), dev)  # [fh, h0]
    rh = device_constant(("linear_t", w0, fw), lambda: linear_matrix(w0, fw).T.copy(),
                         dev)                                                      # [w0, fw]
    wvec = device_constant("luma_bgr", lambda: np.float32([0.114, 0.587, 0.299]), dev) / 255.0
    whc = (rh[:, None, :] * wvec[None, :, None]).reshape(w0 * 3, fw)
    cast = operands
    x = cast(frames_u8.reshape(b, f, h0, w0 * 3).float())
    t = torch.matmul(x, cast(whc))                                # [B,F,h0,fw]
    gray = torch.matmul(cast(rv), cast(t))                        # [B,F,fh,fw]
    return gray, (w0 / fw, h0 / fh)


def _rescue_fast_motion(i0, i1, u, v, warped: bool, tvl1: TVL1Params,
                        max_disp: int = 6):
    """Re-solve clamp-saturated pairs cold with a doubled window, decided at
    once (the port's _rescue_fast_motion with wait=True, one device)."""
    n, h, w = u.shape
    mag = torch.maximum(u.abs(), v.abs())
    pooled = mag[:, :h // 4 * 4, :w // 4 * 4].reshape(
        n, h // 4, 4, w // 4, 4).mean(dim=(2, 4))
    peak = pooled.reshape(n, -1).amax(dim=1)
    k = max(1, int(round(n * tvl1.rescue_frac)))
    trig = peak >= tvl1.rescue_trigger * max_disp
    idx = torch.topk(peak, k).indices
    if not bool(trig.any()):
        return u, v
    wide_fn = tvl1_warped_flow if warped else tvl1_flow
    uw, vw = wide_fn(i0[idx].contiguous(), i1[idx].contiguous(), tvl1,
                     max_disp=2 * max_disp)
    sel = trig[idx][:, None, None]
    u, v = u.clone(), v.clone()
    u[idx] = torch.where(sel, uw, u[idx])
    v[idx] = torch.where(sel, vw, v[idx])
    return u, v


@dataclasses.dataclass
class Plan:
    tick_idx: torch.Tensor
    stack_pos: torch.Tensor
    pair_idx: torch.Tensor
    warm: tuple | None


def plan(f_len: int, cfg, device) -> Plan:
    """The index arrays of a clip of f_len frames (extract.step_plan's
    pair path)."""
    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    ticks = dev(frame_ticks(f_len, cfg.num_ticks, 1) - 1)
    pair_idx, stack_pos = flow_pair_plan(f_len, cfg.num_ticks, cfg.flow_stack_depth)
    warm = None
    if cfg.flow_warm_group > 1:
        key_pos, warm_pos, warm_src = flow_warm_plan(pair_idx, cfg.flow_warm_group)
        if warm_pos.size:
            warm = (dev(key_pos), dev(warm_pos), dev(warm_src))
    return Plan(ticks, dev(stack_pos), dev(pair_idx), warm)


def _flow_input(flow_q: torch.Tensor, plan: Plan, cfg, dtype) -> torch.Tensor:
    """The flow net's input [B, T, crop, crop, 2D]: the tick stacks gathered
    from the quantized flow, x/y interleaved, preprocessed."""
    b = flow_q.shape[0]
    t, d = plan.stack_pos.shape
    h, w = flow_q.shape[2:4]
    stacks = flow_q[:, plan.stack_pos.reshape(-1)].reshape(b, t, d, h, w, 2)
    stacks = stacks.permute(0, 1, 3, 4, 2, 5).reshape(b, t, h, w, d * 2)
    return preprocess_flow(stacks, cfg.frame_resize, cfg.crop_size, dtype=dtype)


@torch.no_grad()
def prepare(frames_u8: torch.Tensor, cfg, tvl1: TVL1Params, dtype=torch.float32,
            gray_operands=lambda x: x):
    """frames u8 [B, F, H, W, 3] BGR -> the networks' NHWC inputs (rgb
    [B, T, crop, crop, 3], flow [B, T, crop, crop, 10]) in ``dtype``, and
    the quantized pair flow u8 [B, P, h, w, 2]."""
    p = plan(frames_u8.shape[1], cfg, frames_u8.device)
    gray, vscale = _flow_gray_grid(frames_u8, cfg.flow_res_div, cfg.flow_gray_matmul,
                                   gray_operands)
    b, np_ = gray.shape[0], p.pair_idx.shape[0]
    i0, i1, u, v = _solve_pairs(gray, p.pair_idx, True, tvl1, p.warm,
                                cfg.flow_warm_camera, 0)
    if tvl1.rescue_frac > 0:
        u, v = _rescue_fast_motion(i0, i1, u, v, True, tvl1)
    h, w = u.shape[1:]
    flow_q = _quantize_pairs(u.reshape(b, np_, h, w), v.reshape(b, np_, h, w),
                             cfg.flow_bound, vscale)
    rgb = preprocess_rgb(frames_u8[:, p.tick_idx], cfg.frame_resize, cfg.crop_size,
                         dtype=dtype)
    return rgb, _flow_input(flow_q, p, cfg, dtype), flow_q
