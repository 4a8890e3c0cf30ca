"""Two-stream feature extraction on one GPU: video -> per-clip signatures.

Port of ``videoquery/pipeline/extract.py``. Per batch of clips, on the
device (the pair path, ``flow_impl="pallas"``, the default everywhere):

  frames u8 [B, F, H, W, 3] -> gray at the flow grid [B, F, fh, fw]
      (or, with the compact uploads, the host's u8 gray [B, F, fh, fw] and
      only the T tick frames, resized and cropped on the host and packed as
      YUV 4:2:0 where the config says so)
      -> warped TV-L1 of the pairs the tick stacks use (K3 camera warps,
         K2 levels; keyframe pairs solve the pyramid, warm pairs refine
         their key's flow; clamp-saturated pairs are re-solved wider)
      -> quantized flow stacks [B, T, fh, fw, 10] and rgb ticks
      -> preprocess -> 2 streams x K splits of BN-Inception (float32 or
         bfloat16 activations, f32 accumulation: ``dtype``)
      -> {stream: [K, B, 1024]} f32 signatures (ticks averaged)

With ``ExtractionConfig(arch="i3d")`` the same step runs I3D (``nn/i3d.py``)
on dense clips: the rgb volume is every frame of the clip, the flow volume
every consecutive pair's plain (unwarped) TV-L1 (u, v) on K2, warm plan and
rescue as above, truncated and scaled to [-1, 1] without quantization; each
stream's one member embeds the whole volume, and its CSV tree carries I3D's
model directory and weights name.

and reference-format CSVs from them (calcSig_wOF.py:116-134). On a CUDA
device the host waits for the card once a batch, to read the rescue's
choice back after the rgb stream's networks are queued (extract_step; the
JAX package decides it under lax.cond), and a batch's payload goes up as
one pinned, non-blocking copy (Extractor._dispatch_payload). With
``flow_impl="xla"`` the flow of every pair of the clip comes from the
gather-warp solver (``kernels/tvl1.py``, plain PyTorch), the flow-quality
gate's baseline; only a caller that names it gets it. The host half
(decode, payload build) is ``pipeline/payload.py``; a video streams through
``Extractor.extract_video_stream`` (a decode thread) or, for many videos,
``extract_videos`` (decode worker processes, ``pipeline/mpstream.py``). The
device is explicit: CUDA unless the caller (or ``VIDEOQUERY_DEVICE``) names
the CPU, where the kernels' plain versions run. TF32 is turned off in the
entry points: the camera's cross-correlation argmax moves under it.

With a (data, model) mesh (``core.meshes.make_mesh``), ``Extractor`` runs
as one process a device, every rank on the same videos: each builds the
batch's host payload, uploads only its data shard of the clips (a tail
shorter than the data axis is padded with its last clip), solves their
flow (a fast-motion rescue chooses among the pairs of the whole batch),
runs only its model shard of each stream's splits, and an all-gather over
each axis assembles {stream: [K, B, 1024]} on every rank in split order.
Only the rank at data and model coordinate 0 writes CSVs.

    python -m videoquery_torch.pipeline.extract synthetic --out feats/ [--dtype bfloat16]
    python -m videoquery_torch.pipeline.extract videos/ --out feats/ --workers 4 \
        --host_gray --host_crop --host_yuv420
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Iterator

import numpy as np
import torch

from videoquery_torch.core.config import FLOW, RGB, ExtractionConfig
from videoquery_torch.core.device import resolve_device
from videoquery_torch.core.meshes import (DATA_AXIS, MODEL_AXIS, all_gather_cat,
                                          data_rank_and_size, model_rank_and_size,
                                          pad_to_multiple)
from videoquery_torch.core.profiling import count, span
from videoquery_torch.core.transfer import device_constant, put_tree
from videoquery_torch.index.csvio import write_features_csv
from videoquery_torch.index.records import FeatureRecord
from videoquery_torch.kernels.resize import linear_matrix, resize2
from videoquery_torch.kernels.tvl1 import TVL1Params
from videoquery_torch.kernels.tvl1 import tvl1_flow as xla_flow
from videoquery_torch.kernels.tvl1 import tvl1_warped_flow as xla_warped_flow
from videoquery_torch.kernels.tvl1_flow import (tvl1_flow, tvl1_flow_warm,
                                                tvl1_warped_flow,
                                                tvl1_warped_flow_cam,
                                                tvl1_warped_flow_warm)
from videoquery_torch.kernels.window_warp import window_warp
from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN
from videoquery_torch.pipeline import decode
from videoquery_torch.pipeline.payload import (BatchPayload, build_payload,
                                               flow_grid_shape, plan_groups,
                                               stream_payloads)
from videoquery_torch.pipeline.preprocess import (preprocess_flow,
                                                  preprocess_flow_i3d,
                                                  preprocess_rgb,
                                                  preprocess_rgb_i3d,
                                                  quantize_flow, scale_flow)
from videoquery_torch.pipeline.sampling import (dense_plan, flow_pair_plan,
                                                flow_stack_index_matrix,
                                                flow_warm_plan, frame_ticks)

log = logging.getLogger(__name__)

# The production flow schedule (extract.py:65-69 of the JAX package, where
# the choice is documented): 4 levels, 3 warps (2 at the finest two), 20
# iterations (10 fine, 6 for a warm pair), gradients of the warped image,
# homography camera, fast-motion rescue of up to 1/8 of the pairs.
PRODUCTION_TVL1 = TVL1Params(n_scales=4, n_warps=3, fine_warps=2,
                             n_iters=20, fine_iters=10, warm_iters=6,
                             grad_source="warped",
                             camera_model="homography",
                             rescue_frac=0.125)


# "pallas": the pairs the stacks use, on K2 and K3; "xla": every pair of the
# clip on the gather-warp solver
FLOW_IMPLS = ("pallas", "xla")


def default_flow_impl() -> str:
    """The port's flow solver on every device: "pallas", K2 and K3 (their
    plain versions on the CPU). The JAX package picks its Pallas kernels on
    a TPU and the gather solver elsewhere; here "xla" runs only where a
    caller names it."""
    return "pallas"


def check_flow_impl(flow_impl: str) -> None:
    if flow_impl not in FLOW_IMPLS:
        raise ValueError(f"flow_impl must be one of {FLOW_IMPLS}; got {flow_impl!r}")


def disable_tf32() -> None:
    """Full-f32 matmuls and convolutions (cuDNN defaults to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def warm_tvl1_params(tvl1: TVL1Params) -> TVL1Params:
    """Refinement schedule of warm-started pairs: warm_warps passes at
    warm_iters (else the fine or the coarse) iterations."""
    return dataclasses.replace(
        tvl1, n_warps=tvl1.warm_warps, fine_warps=tvl1.warm_warps,
        fine_iters=None,
        n_iters=tvl1.warm_iters or tvl1.fine_iters or tvl1.n_iters)


def _clip_flow(gray: torch.Tensor, bound: float, warped: bool, tvl1: TVL1Params,
               impl: str = "xla", value_scale: tuple[float, float] = (1.0, 1.0)
               ) -> torch.Tensor:
    """Quantized flow of every frame of whole clips, dense_flow's layout.

    gray f32 [B, F, H, W] in [0, 1] -> u8 [B, F, H, W, 2] (x, y): frame i
    holds flow i -> i+1 and the last frame repeats the one before
    (build_wof_clips.py:84-100). impl "xla" solves on the gather-warp
    solver, "pallas" on K2 and K3 (no rescue, as in the JAX package)."""
    b, f, h, w = gray.shape
    i0 = gray[:, :-1].reshape(b * (f - 1), h, w).contiguous()
    i1 = gray[:, 1:].reshape(b * (f - 1), h, w).contiguous()
    if impl == "pallas":
        flow_fn = tvl1_warped_flow if warped else tvl1_flow
    else:
        flow_fn = xla_warped_flow if warped else xla_flow
    u, v = flow_fn(i0, i1, tvl1)
    # flow on a reduced grid is in its own pixels: to native pixels per axis
    uv = torch.stack([u * value_scale[0], v * value_scale[1]], dim=-1)
    uv = uv.reshape(b, f - 1, h, w, 2)
    return quantize_flow(torch.cat([uv, uv[:, -1:]], dim=1), bound)


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This rank's share of a batch split over the mesh's "data" axis: the
    rank's clips are rows [rank * per, (rank + 1) * per) of the batch
    padded to size * per clips; its first ``rows`` clips are real, of the
    batch's ``total_rows``."""

    group: object          # the process group of the "data" axis
    rank: int
    size: int
    per: int
    rows: int
    total_rows: int

    @staticmethod
    def of(group, rank: int, size: int, total_rows: int) -> "DataShard":
        per = pad_to_multiple(total_rows, size) // size
        rows = max(0, min(total_rows - rank * per, per))
        return DataShard(group, rank, size, per, rows, total_rows)

    def take(self) -> np.ndarray:
        """The batch rows this rank holds; a padding row repeats the last
        clip."""
        return np.minimum(np.arange(self.rank * self.per, (self.rank + 1) * self.per),
                          self.total_rows - 1)


class _Rescue:
    """The rescue's choice for one batch, queued on the device: whether any
    pair triggered and the top-k pairs by peak, copied as one small int64
    row into pinned host memory behind an event. ``resolve()`` waits for
    that copy, the host's one wait of the batch, and re-solves the chosen
    triggered pairs. Between the two the caller may queue work that does not
    need the flow (extract_step queues the rgb stream's networks), so the
    card stays busy while the host waits: the port's lax.cond."""

    def __init__(self, i0, i1, u, v, peak, k: int, warped: bool, tvl1: TVL1Params,
                 max_disp: int, shard: DataShard | None):
        self.i0, self.i1, self.u, self.v = i0, i1, u, v
        self.warped, self.tvl1, self.max_disp, self.shard = warped, tvl1, max_disp, shard
        self.trig = peak >= tvl1.rescue_trigger * max_disp
        self.idx = torch.topk(peak, k).indices
        choice = torch.cat([self.trig.any().long()[None], self.idx])    # [1 + k]
        self.done = None
        if choice.is_cuda:
            self.host = torch.empty(choice.shape, dtype=torch.int64, pin_memory=True)
            self.host.copy_(choice, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(choice.device))
        else:
            self.host = choice

    def resolve(self):
        """(u, v) with the chosen triggered pairs replaced by their wide
        solve."""
        with span("extract.rescue_wait"):
            if self.done is not None:
                self.done.synchronize()
        fired, *chosen = self.host.tolist()
        u, v = self.u, self.v
        if not fired:
            return u, v
        idx, trig = self.idx, self.trig
        if self.shard is not None:
            # the chosen pairs of this rank's shard, as its local positions,
            # from the host's copy of the choice
            n = u.shape[0]
            lo = self.shard.rank * n
            local = [i - lo for i in chosen if lo <= i < lo + n]
            if not local:
                return u, v
            idx = put_tree(np.asarray(local, np.int64), u.device)
            trig = trig[lo:lo + n]
        count("extract.rescue_pairs", idx.shape[0])
        wide_fn = tvl1_warped_flow if self.warped else tvl1_flow
        uw, vw = wide_fn(self.i0[idx].contiguous(), self.i1[idx].contiguous(), self.tvl1,
                         max_disp=2 * self.max_disp)
        sel = trig[idx][:, None, None]
        u, v = u.clone(), v.clone()
        u[idx] = torch.where(sel, uw, u[idx])
        v[idx] = torch.where(sel, vw, v[idx])
        return u, v


def _rescue_fast_motion(i0, i1, u, v, warped: bool, tvl1: TVL1Params,
                        max_disp: int = 6, shard: DataShard | None = None,
                        wait: bool = True):
    """Re-solve clamp-saturated pairs cold with a doubled window.

    i0/i1 f32 [N, h, w] raw pair images, u/v their solved flow. A pair
    triggers when its peak 4x4-pooled |flow| reaches rescue_trigger *
    max_disp; the top rescue_frac of pairs by that peak are re-solved and
    the triggered ones among them replaced. The JAX package decides this
    under lax.cond on the device; here the choice is made on the device and
    read back once (``_Rescue``). With wait=True the result is (u, v); with
    wait=False the pending ``_Rescue``, whose ``resolve()`` gives (u, v)
    later. torch.topk may order ties differently from lax.top_k, but only
    triggered pairs are replaced, so the order of ties among the others
    does not matter.

    With a shard (pairs clip-major, the same count for each clip) the
    choice is the whole batch's, as in the JAX package's sharded program:
    the peaks are all-gathered over the data axis, the pairs of padding
    clips never chosen, and each rank re-solves its own chosen pairs."""
    n, h, w = u.shape
    mag = torch.maximum(u.abs(), v.abs())
    pooled = mag[:, :h // 4 * 4, :w // 4 * 4].reshape(
        n, h // 4, 4, w // 4, 4).mean(dim=(2, 4))
    peak = pooled.reshape(n, -1).amax(dim=1)
    if shard is None:
        k = max(1, int(round(n * tvl1.rescue_frac)))
    else:
        per_clip = n // shard.per
        real = torch.arange(n, device=peak.device) < shard.rows * per_clip
        peak = all_gather_cat(torch.where(real, peak, -math.inf), shard.group)
        k = max(1, int(round(shard.total_rows * per_clip * tvl1.rescue_frac)))
    rescue = _Rescue(i0, i1, u, v, peak, k, warped, tvl1, max_disp, shard)
    return rescue.resolve() if wait else rescue


def _solve_pairs(gray: torch.Tensor, pair_idx: torch.Tensor, warped: bool,
                 tvl1: TVL1Params, warm_plan=None, warm_camera: str = "own",
                 warm_advect: int = 0):
    """The selected pairs' images and flow before the rescue: (i0, i1, u, v),
    each f32 [B * P, h, w], pairs clip-major (_pair_flow_uv)."""
    b, f, h, w = gray.shape
    i0 = gray[:, pair_idx]
    i1 = gray[:, pair_idx + 1]
    p = pair_idx.shape[0]
    count("extract.flow_pairs", b * p)
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


def _pair_flow_uv(gray: torch.Tensor, pair_idx: torch.Tensor, warped: bool,
                  tvl1: TVL1Params, warm_plan=None, warm_camera: str = "own",
                  warm_advect: int = 0, shard: DataShard | None = None):
    """Raw (u, v) flow of the selected frame pairs, f32 [B, P, h, w] in
    flow-grid pixels. warm_plan (key_pos, warm_pos, warm_src) turns on the
    temporal warm start (sampling.flow_warm_plan): key pairs solve the full
    pyramid, the others refine their key's flow at the finest level; with
    warm_camera "key" or "init" they take (and with "init" refine, a
    homography only) the key pair's camera.

    warm_advect > 0 advects a warm pair's start: a pair j frames from its
    key samples the key's flow where the content came from, u0(x) =
    u_key(x - j * u_key(x)), one K3 call with window d = warm_advect, which
    must cover max |j| * the flow (group // 2 * max_disp, max_disp = 6 by
    default, at the production schedule). shard: gray is this rank's data shard (the rescue's
    choice is the whole batch's)."""
    b, p = gray.shape[0], pair_idx.shape[0]
    i0, i1, u, v = _solve_pairs(gray, pair_idx, warped, tvl1, warm_plan, warm_camera,
                                warm_advect)
    if tvl1.rescue_frac > 0:
        u, v = _rescue_fast_motion(i0, i1, u, v, warped, tvl1, shard=shard)
    h, w = u.shape[1:]
    return u.reshape(b, p, h, w), v.reshape(b, p, h, w)


def _quantize_pairs(u: torch.Tensor, v: torch.Tensor, bound: float,
                    value_scale: tuple[float, float]) -> torch.Tensor:
    """(u, v) f32 [B, P, h, w] in flow-grid pixels -> u8 [B, P, h, w, 2]
    quantized in native pixels (value_scale (sx, sy))."""
    uv = torch.stack([u * value_scale[0], v * value_scale[1]], dim=-1)
    return quantize_flow(uv, bound)


def _pair_flow(gray, pair_idx, bound: float, warped: bool, tvl1: TVL1Params,
               value_scale: tuple[float, float], warm_plan=None,
               warm_camera: str = "own", warm_advect: int = 0,
               shard: DataShard | None = None) -> torch.Tensor:
    """Quantized flow of the selected pairs: u8 [B, P, h, w, 2]. value_scale
    (sx, sy) converts flow-grid pixels to native pixels."""
    u, v = _pair_flow_uv(gray, pair_idx, warped, tvl1, warm_plan, warm_camera,
                         warm_advect, shard)
    return _quantize_pairs(u, v, bound, value_scale)


def _bf16_operands(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and widened back: a product of two such values
    is exact in f32, so an f32 matmul of them is a bf16 x bf16 -> f32 dot."""
    return x.to(torch.bfloat16).float()


def _yuv420_to_bgr(yuv: torch.Tensor) -> torch.Tensor:
    """I420 uint8 [..., H*3//2, W] -> float32 BGR [..., H, W, 3] in [0, 255]:
    nearest 2x chroma upsample and the BT.601 studio-swing constants of
    cv2's own YUV2BGR_I420 (within 2 LSB of it). The device inverse of
    decode.bgr_to_yuv420 (ExtractionConfig.host_yuv420)."""
    hh, w = yuv.shape[-2:]
    h = hh * 2 // 3
    lead = tuple(yuv.shape[:-2])
    y = yuv[..., :h, :].float()
    # I420: Y [h, w], then the U and V planes of [h//2, w//2] each, packed
    # row-major into h//4 rows of width w apiece
    uv = yuv[..., h:, :].reshape(lead + (2, h // 2, w // 2))
    u = uv[..., 0, :, :].float() - 128.0
    v = uv[..., 1, :, :].float() - 128.0
    u = u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    v = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    yf = 1.1643836 * (y - 16.0)
    b = yf + 2.0172321 * u
    g = yf - 0.3917623 * u - 0.8129676 * v
    r = yf + 1.5960267 * v
    return torch.stack([b, g, r], dim=-1).clamp(0.0, 255.0)


def _flow_gray_grid(frames_u8: torch.Tensor, flow_res_div: int,
                    matmul: bool = True):
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
    cast = (lambda x: x) if dev.type == "cpu" else _bf16_operands
    x = cast(frames_u8.reshape(b, f, h0, w0 * 3).float())
    t = torch.matmul(x, cast(whc))                                # [B,F,h0,fw]
    gray = torch.matmul(cast(rv), cast(t))                        # [B,F,fh,fw]
    return gray, (w0 / fw, h0 / fh)


@dataclasses.dataclass
class StepPlan:
    """Device index arrays of one clip length (cached per length)."""

    tick_idx: torch.Tensor       # [T] 0-based rgb tick frames (I3D: every frame)
    stack_pos: torch.Tensor | None  # [T, D] positions into pair_idx ("pallas") or
                                 # flow frames (flow_stack_index_matrix, "xla");
                                 # None for I3D, whose flow volume is every pair
    pair_idx: torch.Tensor | None  # [P] flow pairs the stacks use ("pallas")
    warm: tuple | None           # (key_pos, warm_pos, warm_src) or None


def step_plan(f_len: int, cfg: ExtractionConfig, flow_impl: str, device) -> StepPlan:
    """The index arrays of a clip of f_len frames, on the device: the rgb
    ticks, and for "pallas" the pairs the flow stacks use, their positions
    and the warm plan (cfg.flow_warm_group > 1); for "xla" the stacks'
    flow frames (flow_stack_index_matrix: pair_idx[stack_pos] clamped,
    the same flow). For I3D (cfg.arch) the dense plan: every frame and
    every consecutive pair (sampling.dense_plan), "pallas" only."""
    check_flow_impl(flow_impl)

    def dev(a):
        return put_tree(np.asarray(a, np.int64), device)

    if cfg.arch == "i3d":
        if flow_impl != "pallas":
            raise ValueError("I3D's dense flow runs on the port's kernels (flow_impl='pallas')")
        frames, pair_idx = dense_plan(f_len)
        ticks, stack_pos = dev(frames), None
    else:
        ticks = dev(frame_ticks(f_len, cfg.num_ticks, 1) - 1)
        if flow_impl == "xla":
            return StepPlan(ticks, dev(flow_stack_index_matrix(
                f_len, cfg.num_ticks, cfg.flow_stack_depth)), None, None)
        pair_idx, stack_pos = flow_pair_plan(f_len, cfg.num_ticks, cfg.flow_stack_depth)
        stack_pos = dev(stack_pos)
    warm = None
    if cfg.flow_warm_group > 1:
        key_pos, warm_pos, warm_src = flow_warm_plan(pair_idx, cfg.flow_warm_group)
        if warm_pos.size:
            warm = (dev(key_pos), dev(warm_pos), dev(warm_src))
    return StepPlan(ticks, stack_pos, dev(pair_idx), warm)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# architecture -> the CSV tree's (model directory, weights name) templates
CSV_NAMES = {
    "bn_inception": ("UCF101_split{split}", "ucf101_split{split}_tsn_{stream}_bn_inception.npz"),
    "i3d": ("Kinetics400_I3D_split{split}", "kinetics400_i3d_{stream}.npz"),
}


def ensemble_embed(stream: StreamEnsemble, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """[K, N, 1024] embeddings of a stream's K-split ensemble on x: images
    [N, H, W, C] for BN-Inception members, volumes [N, T, H, W, C] for
    I3D's. With a mesh this rank runs only its model shard of the
    splits (``StreamEnsemble.shard``) and an all-gather over "model"
    assembles the K in split order, whatever the axis's size: the JAX
    package's ``_ensemble_embed`` (shard_map, out_specs P(MODEL, DATA)) on
    this rank's rows."""
    if mesh is None:
        return stream.embed(x)
    local = stream.shard(*model_rank_and_size(mesh)).embed(x)
    return all_gather_cat(local, mesh.get_group(MODEL_AXIS), dim=0)


def _flow_gray(frames_u8: torch.Tensor, cfg: ExtractionConfig,
               gray_u8: torch.Tensor | None, native_hw: tuple[int, int] | None):
    """Gray f32 [B, F, fh, fw] at the flow grid and the flow-grid to
    native-pixel value scale: the device's gray of the frames, or the
    host's u8 gray (the compact upload)."""
    if gray_u8 is None:
        return _flow_gray_grid(frames_u8, cfg.flow_res_div, cfg.flow_gray_matmul)
    if native_hw is not None:
        h0, w0 = native_hw
    else:
        if cfg.host_crop:
            raise ValueError("host_crop needs native_hw: the cropped "
                             "tick frames no longer carry the native "
                             "size the flow values must scale to")
        h0, w0 = frames_u8.shape[2], frames_u8.shape[3]
    fh, fw = gray_u8.shape[2], gray_u8.shape[3]
    return gray_u8.float() / 255.0, (w0 / fw, h0 / fh)


def _rgb_input(frames_u8: torch.Tensor, plan: StepPlan, cfg: ExtractionConfig,
               dtype: str, compact: bool) -> torch.Tensor:
    """The rgb net's input [B, T, crop, crop, 3] in ``dtype``: the tick
    frames (gathered here, or by the host with the compact upload, then
    maybe resized, cropped and packed as I420 there too), preprocessed.
    For I3D the volume of every frame, in RGB order in [-1, 1]."""
    if cfg.arch == "i3d":
        return preprocess_rgb_i3d(frames_u8[:, plan.tick_idx], cfg.frame_resize,
                                  cfg.crop_size, dtype=DTYPES[dtype])
    host_cropped = compact and cfg.host_crop
    if compact:
        rgb_ticks = frames_u8          # the host gathered the tick frames
        if host_cropped and cfg.host_yuv420:
            rgb_ticks = _yuv420_to_bgr(rgb_ticks)    # f32 [B,T,crop,crop,3]
    else:
        rgb_ticks = frames_u8[:, plan.tick_idx]                     # [B,T,H,W,3]
    return preprocess_rgb(rgb_ticks, cfg.frame_resize, cfg.crop_size, dtype=DTYPES[dtype],
                          precropped=host_cropped)


def _flow_field(u: torch.Tensor, v: torch.Tensor, cfg: ExtractionConfig,
                value_scale: tuple[float, float]) -> torch.Tensor:
    """The pairs' flow (u, v) f32 [B, P, h, w] in flow-grid pixels as the
    flow net reads it, [B, P, h, w, 2] in native pixels (value_scale (sx,
    sy)): u8 quantized for BN-Inception, truncated and scaled to [-1, 1]
    (f32) for I3D."""
    if cfg.arch == "i3d":
        uv = torch.stack([u * value_scale[0], v * value_scale[1]], dim=-1)
        return scale_flow(uv, cfg.flow_bound)
    return _quantize_pairs(u, v, cfg.flow_bound, value_scale)


def _flow_input(flow_q: torch.Tensor, plan: StepPlan, cfg: ExtractionConfig,
                dtype: str) -> torch.Tensor:
    """The flow net's input [B, T, crop, crop, 2D] in ``dtype``: the tick
    stacks gathered from the quantized flow, x/y interleaved, preprocessed.
    For I3D the volume of every pair's scaled flow (_flow_field), [B, P,
    crop, crop, 2]."""
    if cfg.arch == "i3d":
        return preprocess_flow_i3d(flow_q, cfg.frame_resize, cfg.crop_size,
                                   dtype=DTYPES[dtype])
    b = flow_q.shape[0]
    t, d = plan.stack_pos.shape
    h, w = flow_q.shape[2:4]
    stacks = flow_q[:, plan.stack_pos.reshape(-1)].reshape(b, t, d, h, w, 2)
    # interleave x/y per depth -> channels [x1, y1, ..., xD, yD]
    stacks = stacks.permute(0, 1, 3, 4, 2, 5).reshape(b, t, h, w, d * 2)
    return preprocess_flow(stacks, cfg.frame_resize, cfg.crop_size, dtype=DTYPES[dtype])


def _stream_embed(stream: StreamEnsemble, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """A stream's ensemble on its input [B, T, H, W, C] -> f32 [K, B, 1024]:
    each tick embedded and the ticks averaged, or (I3D: ``temporal``) each
    clip's volume embedded whole."""
    if stream.temporal:
        return ensemble_embed(stream, x, mesh)
    b, t = x.shape[:2]
    emb = ensemble_embed(stream, x.reshape((b * t,) + x.shape[2:]), mesh)
    return emb.reshape(emb.shape[0], b, t, -1).mean(dim=2)


@torch.no_grad()
def prepare_step(frames_u8: torch.Tensor, plan: StepPlan, cfg: ExtractionConfig,
                 warped: bool, tvl1: TVL1Params, dtype: str = "float32",
                 gray_u8: torch.Tensor | None = None,
                 native_hw: tuple[int, int] | None = None, flow_impl: str = "pallas",
                 warm_advect: int = 0, shard: DataShard | None = None):
    """The first half of extract_step, everything before the networks:
    gray at the flow grid, the flow (the rescue decided at once), the tick
    and stack gathers and the preprocess. Returns the networks' NHWC inputs
    (rgb [B, T, crop, crop, 3], flow [B, T, crop, crop, 10]; I3D's volumes
    [B, F, crop, crop, 3] and [B, F - 1, crop, crop, 2]) in ``dtype``;
    embed_step on them gives extract_step's result bit for bit."""
    check_flow_impl(flow_impl)
    with span("extract.flow", frames_u8.device):
        gray, vscale = _flow_gray(frames_u8, cfg, gray_u8, native_hw)
        if cfg.arch == "i3d":
            u, v = _pair_flow_uv(gray, plan.pair_idx, warped, tvl1, plan.warm,
                                 cfg.flow_warm_camera, warm_advect, shard)
            flow_q = _flow_field(u, v, cfg, vscale)                    # [B,P,h,w,2]
        elif flow_impl == "pallas":
            flow_q = _pair_flow(gray, plan.pair_idx, cfg.flow_bound, warped, tvl1, vscale,
                                plan.warm, cfg.flow_warm_camera, warm_advect,
                                shard)                                  # [B,P,h,w,2]
        else:
            flow_q = _clip_flow(gray, cfg.flow_bound, warped, tvl1, flow_impl,
                                vscale)                                      # [B,F,h,w,2]
    return (_rgb_input(frames_u8, plan, cfg, dtype, gray_u8 is not None),
            _flow_input(flow_q, plan, cfg, dtype))


@torch.no_grad()
def embed_step(tsn: TwoStreamTSN, rgb_in: torch.Tensor, flow_in: torch.Tensor,
               mesh=None):
    """The second half of extract_step: both streams' ensembles on
    prepare_step's inputs, ticks averaged -> (rgb, flow) f32 [K, B, 1024]
    (ensemble_embed: with a mesh, this rank's model shard and the
    all-gather over "model")."""
    with span("extract.rgb_net", rgb_in.device):
        rgb = _stream_embed(tsn.rgb, rgb_in, mesh)
    with span("extract.flow_net", flow_in.device):
        flow = _stream_embed(tsn.flow, flow_in, mesh)
    return rgb, flow


@torch.no_grad()
def extract_step(tsn: TwoStreamTSN, frames_u8: torch.Tensor, plan: StepPlan,
                 cfg: ExtractionConfig, warped: bool, tvl1: TVL1Params,
                 dtype: str = "float32", gray_u8: torch.Tensor | None = None,
                 native_hw: tuple[int, int] | None = None, flow_impl: str = "pallas",
                 warm_advect: int = 0, mesh=None, shard: DataShard | None = None):
    """One batch: frames u8 [B, F, H, W, 3] BGR -> (rgb, flow) f32
    embeddings, each [K, B, 1024]. ``dtype`` ("float32" or "bfloat16") is
    the networks' working type; the flow is f32 either way. flow_impl
    "pallas" solves the plan's pairs on K2 and K3 (with its warm plan, and
    warm_advect: _pair_flow_uv), "xla" every pair of the clip on the
    gather-warp solver (the plan's stacks then index flow frames).

    The compact upload (cfg.host_gray, build_payload's layouts): gray_u8 u8
    [B, F, fh, fw] is the host's gray at the flow grid, and frames_u8 holds
    only the tick frames [B, T, H, W, 3]; with cfg.host_crop they are
    already resized and cropped ([B, T, crop, crop, 3]; then native_hw, the
    (H, W) the gray was computed from, is required), with cfg.host_yuv420
    packed as I420 [B, T, crop * 3 // 2, crop]. native_hw sets the flow-grid
    to native-pixel value scale.

    With a mesh, frames_u8 is this rank's data shard (``shard``) and the
    networks run this rank's model shard; the result is this rank's B clips
    with all K splits.

    The host never waits for the card here but once, on a CUDA device with
    the fast-motion rescue on: its choice is queued on the card, then the
    rgb stream's networks, and only then does the host read the choice back
    (``_Rescue``), re-solve the chosen pairs and queue the flow stream. The
    result equals embed_step(prepare_step(...)) bit for bit: the same
    kernels on the same inputs, queued in another order."""
    if flow_impl != "pallas" or tvl1.rescue_frac <= 0:
        # no rescue to decide: nothing on this path waits for the card
        return embed_step(tsn, *prepare_step(frames_u8, plan, cfg, warped, tvl1, dtype,
                                             gray_u8, native_hw, flow_impl, warm_advect,
                                             shard), mesh)
    dev = frames_u8.device
    with span("extract.flow", dev):
        gray, vscale = _flow_gray(frames_u8, cfg, gray_u8, native_hw)
        b, p = gray.shape[0], plan.pair_idx.shape[0]
        i0, i1, u, v = _solve_pairs(gray, plan.pair_idx, warped, tvl1, plan.warm,
                                    cfg.flow_warm_camera, warm_advect)
        rescue = _rescue_fast_motion(i0, i1, u, v, warped, tvl1, shard=shard, wait=False)
    with span("extract.rgb_net", dev):
        rgb = _stream_embed(tsn.rgb, _rgb_input(frames_u8, plan, cfg, dtype,
                                                gray_u8 is not None), mesh)
    with span("extract.flow_net", dev):
        u, v = rescue.resolve()               # the batch's one wait for the card
        h, w = u.shape[1:]
        flow_q = _flow_field(u.reshape(b, p, h, w), v.reshape(b, p, h, w), cfg, vscale)
        flow = _stream_embed(tsn.flow, _flow_input(flow_q, plan, cfg, dtype), mesh)
    return rgb, flow


@dataclasses.dataclass
class ClipSignatures:
    """Per-batch signatures; rgb/flow may be device tensors until
    gather_signatures downloads them."""

    clip_numbers: list[int]
    rgb: "np.ndarray | torch.Tensor"   # [K, B, 1024]
    flow: "np.ndarray | torch.Tensor"  # [K, B, 1024]
    splits: tuple[int, ...]

    def materialize(self) -> "ClipSignatures":
        """These signatures as f32 numpy arrays on the host (one download
        each; gather_signatures downloads a list in one copy)."""
        def host(x):
            if isinstance(x, torch.Tensor):
                return x.detach().float().cpu().numpy()
            return np.asarray(x, np.float32)

        return ClipSignatures(self.clip_numbers, host(self.rgb), host(self.flow),
                              self.splits)


def gather_signatures(sigs: list[ClipSignatures]) -> list[ClipSignatures]:
    """Download device signatures with one device-to-host copy."""
    device = [s for s in sigs if isinstance(s.rgb, torch.Tensor)]
    if not device:
        return sigs
    flat = torch.cat([torch.stack([s.rgb, s.flow]).reshape(2, s.rgb.shape[0], -1)
                      for s in device], dim=2)                 # [2, K, sum(B)*D]
    host = flat.float().cpu().numpy()
    out, offset = [], 0
    for s in sigs:
        if not isinstance(s.rgb, torch.Tensor):
            out.append(s)
            continue
        k, b, d = s.rgb.shape
        chunk = host[:, :, offset:offset + b * d].reshape(2, k, b, d)
        out.append(ClipSignatures(s.clip_numbers, chunk[0], chunk[1], s.splits))
        offset += b * d
    return out


class Extractor:
    """Two-stream signature extractor on one device. flow_impl "pallas" (the
    default on every device) solves flow on K2 and K3; "xla" on the
    gather-warp solver (extract_step).

    With a mesh (a (data, model) DeviceMesh of the initialized world, on
    this device's type: ``core.meshes.make_mesh``), every rank runs the
    same calls on the same videos: clip batches split over "data", each
    stream's splits over "model" (which must divide them: ValueError
    otherwise, as the JAX package's shard_map cannot split them either),
    and every rank gets the whole batch's signatures. The JAX package's
    ``Extractor(mesh=...)``; unlike it, a batch shorter than the data axis
    (a tail clip) runs, padded with its last clip (ROADMAP §3)."""

    def __init__(self, tsn: TwoStreamTSN, cfg: ExtractionConfig | None = None,
                 warped: bool | None = None, tvl1: TVL1Params | None = None, device=None,
                 dtype: str = "float32", flow_impl: str = "pallas", mesh=None):
        self.cfg = cfg or ExtractionConfig()
        self.tvl1 = tvl1 or PRODUCTION_TVL1
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}; got {dtype!r}")
        check_flow_impl(flow_impl)
        if tsn.rgb.temporal != (self.cfg.arch == "i3d") or \
                tsn.flow.temporal != tsn.rgb.temporal:
            raise ValueError(f"the networks do not match arch {self.cfg.arch!r}")
        if warped is None:
            # each architecture's flow: TSN's warped stream, I3D's plain TV-L1
            warped = self.cfg.arch == "bn_inception"
        if (warped and self.cfg.flow_warm_camera == "init"
                and self.tvl1.camera_model != "homography"):
            # the warm pairs' refinement exists for homographies only: an
            # affine key camera is reused as it is ("key"), as in the JAX
            # package, which warns the same
            log.warning("flow_warm_camera='init' requires camera_model='homography' "
                        "(got %r); warm groups will reuse the stale key camera "
                        "('key' behavior)", self.tvl1.camera_model)
        self.dtype = dtype
        self.flow_impl = flow_impl
        self.flow_res_div = self.cfg.flow_res_div
        if self.cfg.feature_blob != "global_pool":
            # the net only computes global_pool; another name would label
            # global_pool vectors wrongly in the CSVs
            raise ValueError(f"feature_blob must be 'global_pool'; got "
                             f"{self.cfg.feature_blob!r}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self._data = (None, 0, 1)            # (group, rank, size) of "data"
        self._model = (0, 1)                 # (rank, size) of "model"
        local = tsn
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"mesh on {mesh.device_type}, extractor on {self.device}")
            rank, size = data_rank_and_size(mesh)
            self._data = (mesh.get_group(DATA_AXIS), rank, size)
            self._model = model_rank_and_size(mesh)
            # only this rank's model shard of each stream runs here
            # (StreamEnsemble.shard raises unless the axis divides K)
            local = TwoStreamTSN(tsn.rgb.shard(*self._model), tsn.flow.shard(*self._model))
        disable_tf32()
        for net in local.rgb.nets + local.flow.nets:
            net.to(self.device)
        self.tsn = tsn
        self.warped = warped
        self._plans: dict[int, StepPlan] = {}

    @property
    def writes_output(self) -> bool:
        """Whether this rank writes CSVs: the one at data and model
        coordinate 0, or the only one."""
        return self._data[1] == 0 and self._model[0] == 0

    def _plan(self, f_len: int) -> StepPlan:
        """Index arrays for a clip length, on the device, cached."""
        plan = self._plans.get(f_len)
        if plan is None:
            plan = self._plans[f_len] = step_plan(f_len, self.cfg, self.flow_impl,
                                                  self.device)
        return plan

    def extract_frames(self, frames: np.ndarray, clip_numbers=None
                       ) -> Iterator[ClipSignatures]:
        """frames: BGR uint8 [N, H, W, 3] of a whole video. Yields batches of
        per-clip signatures (device tensors)."""
        for group, nums in plan_groups(len(frames), self.cfg, clip_numbers):
            yield self._dispatch_payload(build_payload(
                frames, None, group, nums, self.cfg, self.flow_res_div))

    def _dispatch_payload(self, payload: BatchPayload) -> ClipSignatures:
        """The device half of a batch: upload a host-built payload and run
        extract_step on it. Payloads come from extract_frames, from this
        process's decode thread (extract_video_stream) or from decode worker
        processes (pipeline/mpstream.py); their arrays may be reused as soon
        as this returns (``put_tree`` packs them into pinned memory first).
        With a mesh only this rank's clips go up, and the whole batch's
        signatures come back by an all-gather over "data", whatever the
        axis's size. On a CUDA device the host waits for the card once a
        batch, in extract_step."""
        clip_rgb, gray = payload.clip_rgb, payload.gray
        shard = None
        if self.mesh is not None:
            shard = DataShard.of(*self._data, len(payload.nums))
            if shard.size > 1:         # with one rank take() is every row
                rows = shard.take()
                clip_rgb = clip_rgb[rows]
                gray = None if gray is None else gray[rows]
        with span("extract.dispatch"):
            # both payloads are uint8: one pinned buffer, one copy up, queued
            # without a host wait (the JAX package's device_put_tree)
            with span("extract.upload", self.device):
                if gray is None:
                    frames_dev, gray_dev = put_tree(clip_rgb, self.device), None
                else:
                    frames_dev, gray_dev = put_tree((clip_rgb, gray), self.device)
            rgb, flow = extract_step(self.tsn, frames_dev, self._plan(payload.f_len),
                                     self.cfg, self.warped, self.tvl1, self.dtype,
                                     gray_u8=gray_dev, native_hw=payload.native_hw,
                                     flow_impl=self.flow_impl, mesh=self.mesh,
                                     shard=shard)
            if shard is not None:
                b = shard.total_rows
                rgb = all_gather_cat(rgb, shard.group, dim=1)[:, :b]
                flow = all_gather_cat(flow, shard.group, dim=1)[:, :b]
        return ClipSignatures(payload.nums, rgb, flow, self.tsn.rgb.splits)

    def extract_video_stream(self, path: str,
                             new_size: tuple[int, int] | None = None
                             ) -> list[ClipSignatures]:
        """Decode on a producer thread while this thread uploads and runs
        the batches: stream_payloads (decode, gray, payload build; cv2
        releases the GIL) feeds a bounded queue of
        max(2, cfg.stream_window_batches) payloads, so host memory stays a
        few batches whatever the video's length and the wall clock
        approaches max(decode, device) instead of their sum. A decode error
        is raised here, never a silently shorter feature set. Returns the
        batches sorted by clip, downloaded in one copy."""
        import queue
        import threading

        if new_size is None:
            new_size = self._decode_size()
        q: "queue.Queue" = queue.Queue(
            maxsize=max(2, self.cfg.stream_window_batches))
        end = object()

        def producer():
            try:
                for payload in stream_payloads(path, self.cfg,
                                               self.flow_res_div, new_size):
                    q.put(payload)
                q.put(end)
            except BaseException as exc:  # noqa: BLE001 — handed to the consumer
                q.put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        sigs: list[ClipSignatures] = []
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            sigs.append(self._dispatch_payload(item))
        t.join()
        sigs.sort(key=lambda s: s.clip_numbers[0])
        return gather_signatures(sigs)

    def extract_videos(self, paths, workers: int = 0, new_size=None):
        """Many videos with decode worker PROCESSES (pipeline/mpstream.py):
        {path: [ClipSignatures]}. workers=0 picks cpu_count - 1."""
        from videoquery_torch.pipeline.mpstream import extract_videos_mp

        return extract_videos_mp(self, paths, workers=workers,
                                 new_size=new_size)

    def _decode_size(self) -> tuple[int, int] | None:
        return self.cfg.frame_resize if self.cfg.decode_at_target else None

    def extract_video(self, path: str) -> list[ClipSignatures]:
        frames = decode.load_video(path, new_size=self._decode_size())
        return gather_signatures(list(self.extract_frames(frames)))

    # -- reference-format CSV output (calcSig_wOF.py:116-134 layout) ---------

    def write_csv_tree(self, signatures: list[ClipSignatures], out_dir: str,
                       video: str, video_url: str,
                       modelname_fmt: str | None = None,
                       weights_uri_fmt: str | None = None,
                       ) -> list[str]:
        """One CSV per (split, stream) under <out>/<video>/<modelname>/.
        The names default to the architecture's (CSV_NAMES); a model
        directory ends in its split's digit, which the loader reads. With a
        mesh only the rank at data and model coordinate 0 writes (the
        others return [])."""
        if not signatures or not self.writes_output:
            return []
        default_model, default_weights = CSV_NAMES[self.cfg.arch]
        modelname_fmt = modelname_fmt or default_model
        weights_uri_fmt = weights_uri_fmt or default_weights
        signatures = gather_signatures(signatures)
        paths = []
        for ki, split in enumerate(signatures[0].splits):
            d = os.path.join(out_dir, video, modelname_fmt.format(split=split))
            os.makedirs(d, exist_ok=True)
            for stream, attr in ((RGB, "rgb"), (FLOW, "flow")):
                rows = []
                for sig in signatures:
                    rows.extend(zip(sig.clip_numbers, getattr(sig, attr)[ki]))
                rows.sort(key=lambda r: r[0])
                path = os.path.join(d, f"{stream}_{self.cfg.feature_blob}_features.csv")
                write_features_csv(
                    path, video, video_url, stream, self.cfg.feature_blob,
                    weights_uri_fmt.format(split=split, stream=attr), rows)
                paths.append(path)
        return paths

    def records(self, signatures: list[ClipSignatures],
                clip_id_of: dict[int, int] | None = None) -> list[FeatureRecord]:
        out = []
        for sig in gather_signatures(signatures):
            for ki, split in enumerate(sig.splits):
                for bi, clip_no in enumerate(sig.clip_numbers):
                    cid = clip_id_of[clip_no] if clip_id_of else clip_no
                    out.append(FeatureRecord(cid, RGB, split, self.cfg.feature_blob,
                                             sig.rgb[ki, bi]))
                    out.append(FeatureRecord(cid, FLOW, split, self.cfg.feature_blob,
                                             sig.flow[ki, bi]))
        return out


def main(argv=None) -> None:
    """CLI: extract features for every video of a directory (or one video,
    or a synthetic clip) into a reference-format CSV tree."""
    import argparse
    import glob

    p = argparse.ArgumentParser(description="Two-stream TSN or I3D feature extraction "
                                            "(PyTorch/CUDA port)")
    p.add_argument("src", help="video file, directory of videos, or 'synthetic'")
    p.add_argument("--out", required=True, help="output feature-CSV tree root")
    p.add_argument("--weights", default=None,
                   help="npz weight bundle dir (from convert_caffe); random if omitted")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--arch", default="bn_inception", choices=sorted(CSV_NAMES),
                   help="the networks: TSN's BN-Inception, or I3D on dense clips")
    p.add_argument("--splits", type=int, nargs="+", default=None,
                   help="default 1 2 3 (bn_inception), 1 (i3d)")
    p.add_argument("--num_ticks", type=int, default=25)
    p.add_argument("--fps", type=int, default=None,
                   help="default 15 (bn_inception), 25 (i3d)")
    p.add_argument("--clip_time", type=int, default=10)
    p.add_argument("--batch_clips", type=int, default=8)
    p.add_argument("--no-warp", action="store_true", help="plain (unwarped) TV-L1")
    p.add_argument("--ext", default="mp4")
    p.add_argument("--modelname", default=None,
                   help="per-split model dir name template (default: the "
                        "architecture's, Extractor.write_csv_tree)")
    p.add_argument("--new_width", type=int, default=0, help="decode resize width")
    p.add_argument("--new_height", type=int, default=0, help="decode resize height")
    p.add_argument("--flow_res_div", type=int, default=2,
                   help="compute flow at frame_res/div")
    p.add_argument("--host_gray", action="store_true",
                   help="compact upload: the host's cv2 gray at the flow grid and "
                        "the tick frames only (ExtractionConfig.host_gray)")
    p.add_argument("--host_crop", action="store_true",
                   help="with --host_gray: resize and crop the tick frames on the "
                        "host too (ExtractionConfig.host_crop)")
    p.add_argument("--host_yuv420", action="store_true",
                   help="with --host_crop: ship the tick frames as YUV 4:2:0 and "
                        "rebuild BGR on the device (ExtractionConfig.host_yuv420)")
    p.add_argument("--workers", type=int, default=1,
                   help="decode worker PROCESSES (> 1 with several videos: "
                        "pipeline/mpstream.py)")
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                   help="the networks' working type (f32 accumulation either way)")
    args = p.parse_args(argv)
    i3d = args.arch == "i3d"
    splits = tuple(args.splits or ([1] if i3d else [1, 2, 3]))
    if i3d and args.weights:
        raise SystemExit("--weights: no converter for I3D's Kinetics checkpoints yet; "
                         "omit it for seeded weights")

    cfg = ExtractionConfig(fps=args.fps or (25 if i3d else 15), clip_seconds=args.clip_time,
                           num_ticks=args.num_ticks, batch_clips=args.batch_clips,
                           flow_res_div=args.flow_res_div, host_gray=args.host_gray,
                           host_crop=args.host_crop, host_yuv420=args.host_yuv420,
                           arch=args.arch)
    if args.src == "synthetic":
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "_synthetic.mp4")
        decode.synthesize_video(path, n_frames=320)
        videos = [path]
    elif os.path.isdir(args.src):
        videos = sorted(glob.glob(os.path.join(args.src, f"*.{args.ext}")))
        if not videos:
            raise SystemExit(f"no *.{args.ext} videos in {args.src!r}")
    elif os.path.isfile(args.src):
        videos = [args.src]
    else:
        raise SystemExit(f"input not found: {args.src!r}")
    new_size = None
    if args.new_width or args.new_height:
        if not (args.new_width and args.new_height):
            raise SystemExit("--new_width and --new_height must be set together")
        new_size = (args.new_width, args.new_height)

    device = resolve_device()
    if args.weights:
        tsn = TwoStreamTSN.from_npz_dir(args.weights, splits, device)
    else:
        log.warning("no --weights: using random-initialized %s (pipeline demo)", args.arch)
        tsn = TwoStreamTSN.random(args.seed, splits, device, args.arch)
    ex = Extractor(tsn, cfg, warped=False if args.no_warp else None, device=device,
                   dtype=args.dtype)
    new_size = new_size or ex._decode_size()

    t0 = time.time()
    if args.workers > 1 and len(videos) > 1:
        # worker processes decode distinct videos while this process uploads
        # and runs the batches
        by_path = ex.extract_videos(videos, workers=args.workers, new_size=new_size)
        how = f"{args.workers} decode workers"
    else:
        # one process: each video streamed, decoded on a host thread while
        # the device runs its batches, in a few batches of host memory
        # (decoding each whole video ahead showed no resolved gain: PERF.md)
        by_path = {vid: ex.extract_video_stream(vid, new_size) for vid in videos}
        how = "one process streaming"
    for vid in videos:
        name = os.path.splitext(os.path.basename(vid))[0]
        if not by_path[vid]:
            log.warning("%s: too short for any clip; skipped", name)
            continue
        ex.write_csv_tree(by_path[vid], args.out, name, vid,
                          modelname_fmt=args.modelname)
    n_clips = sum(len(s.clip_numbers) for sigs in by_path.values() for s in sigs)
    dt = time.time() - t0
    print(f"{len(videos)} videos, {n_clips} clips in {dt:.1f}s "
          f"({n_clips / dt:.2f} clips/s, {how})")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
