"""Host-side batch payloads for extraction (numpy and cv2 only).

A copy of ``videoquery/pipeline/payload.py`` that imports the port's config
(the JAX module imports ``videoquery.core.config``, whose package pulls in
jax): clip planning, flow-grid geometry, the payload build in each upload
layout (all frames; host gray with the tick frames; those frames resized
and cropped on the host; and packed as YUV 4:2:0; the sampled frames
alone of an rgb-only architecture, TimeSformer's or Video Swin's, a
port-only layout), and the constant-memory streaming
generator. Nothing in its import chain loads torch, so a decode
worker process (``pipeline/mpstream.py``) starts with numpy and cv2 alone.
The device half is ``pipeline/extract.py``."""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator

import numpy as np

from videoquery_torch.core.config import ExtractionConfig
from videoquery_torch.pipeline import decode
from videoquery_torch.pipeline.sampling import clip_ranges, frame_ticks
from videoquery_torch.pipeline.temporal_sampling import linspace_frames, view_frames

log = logging.getLogger(__name__)


def flow_grid_shape(h0: int, w0: int, flow_res_div: int) -> tuple[int, int]:
    """(fh, fw) of the reduced flow grid for native frames of (h0, w0).
    Heights snap to multiples of 8 and widths >= 128 to multiples of 128
    (the JAX package's TPU tile rule, kept so that both packages solve flow
    on the same grid: 340x256 frames at flow_res_div=2 give 128x128). Shared
    by the device gray (extract._flow_gray_grid) and the host gray
    (decode.gray_flow_grid)."""
    if flow_res_div <= 1:
        return h0, w0
    fh = max(8, (h0 // flow_res_div) // 8 * 8)
    fw0 = w0 // flow_res_div
    fw = (fw0 // 128 * 128) if fw0 >= 128 else fw0
    return fh, fw


def plan_groups(n_frames: int, cfg: ExtractionConfig, clip_numbers=None):
    """[(group_of_ranges, clip_numbers)]: full clips batched, odd tails
    solo."""
    ranges = clip_ranges(n_frames, cfg.fps, cfg.clip_seconds,
                         cfg.min_tail_seconds)
    if clip_numbers is None:
        clip_numbers = list(range(1, len(ranges) + 1))
    bsz = cfg.batch_clips
    full = [r for r in ranges if r[1] - r[0] + 1 == cfg.frames_per_clip]
    tail = [r for r in ranges if r[1] - r[0] + 1 != cfg.frames_per_clip]
    groups = [full[i:i + bsz] for i in range(0, len(full), bsz)]
    groups += [[r] for r in tail]  # odd-length tails run solo
    return [(g, [clip_numbers[ranges.index(r)] for r in g])
            for g in groups]


@dataclasses.dataclass
class BatchPayload:
    """Host-built upload payload of one clip batch: everything the device
    step needs and no torch state, so a decode worker process can build it
    and send it to the process that owns the card."""

    nums: list[int]                    # clip numbers
    f_len: int                         # real frames per clip (tail < fpc)
    clip_rgb: np.ndarray               # rgb payload (layout depends on cfg)
    gray: "np.ndarray | None"          # [B, fpc, fh, fw] u8 (host_gray)
    native_hw: "tuple[int, int] | None"

    @property
    def nbytes(self) -> int:
        """Bytes the batch uploads."""
        return self.clip_rgb.nbytes + (0 if self.gray is None else self.gray.nbytes)


def rgb_only_frames(f_len: int, cfg: ExtractionConfig) -> np.ndarray:
    """The 0-based frames of a clip of f_len frames that an rgb-only
    payload carries: TimeSformer's num_frames by PySlowFast's linspace
    rule; Video Swin's distinct view frames (``view_frames``), sorted."""
    if cfg.arch == "videoswin":
        return view_frames(f_len, cfg.view_clip_len, cfg.view_frame_interval,
                           cfg.view_clips)[0]
    return linspace_frames(f_len, cfg.num_frames)


def build_payload(frames, gray, group, nums, cfg: ExtractionConfig,
                  flow_res_div: int) -> BatchPayload:
    """The host half of a signature batch (see Extractor._dispatch_payload
    for the device half).

    frames: uint8 [N, H, W, 3] ndarray OR a list of [H, W, 3] frames (the
    streaming window buffer, possibly with a freed None-prefix).
    gray: optional list of per-frame uint8 flow-grid gray, parallel to
    frames (producer-precomputed); ignored unless cfg.host_gray.

    Layouts: all frames u8 [B, fpc, H, W, 3] (tails padded with their last
    frame); with cfg.host_gray the tick frames [B, T, H, W, 3] and the gray
    [B, fpc, fh, fw]; with host_crop the tick frames resized and cropped,
    [B, T, crop, crop, 3]; with host_yuv420 those as I420,
    [B, T, crop * 3 // 2, crop]. For an rgb-only architecture (cfg.rgb_only)
    the frames it reads alone, [B, U, H, W, 3] (``rgb_only_frames`` over
    each clip's real frames: a tail needs no padding)."""
    f_len = group[0][1] - group[0][0] + 1
    is_arr = isinstance(frames, np.ndarray)

    def frame_range(a, b):  # 0-based [a, b)
        return frames[a:b] if is_arr else np.stack(frames[a:b])

    def frame_gather(idxs):  # 0-based index array
        return (frames[idxs] if is_arr
                else np.stack([frames[j] for j in idxs]))

    if cfg.rgb_only:
        sampled = rgb_only_frames(f_len, cfg)
        clip_rgb = np.stack([frame_gather(s - 1 + sampled) for s, _e in group])
        return BatchPayload(list(nums), f_len, clip_rgb, None, None)
    ticks_rgb = frame_ticks(f_len, cfg.num_ticks, 1)
    gray_np = None
    native_hw = None
    if cfg.host_gray:
        # compact upload: only the tick frames and the uint8 gray at the
        # flow grid
        fpc = cfg.frames_per_clip
        h0, w0 = frames[group[0][0] - 1].shape[:2] if not is_arr \
            else frames.shape[1:3]
        native_hw = (int(h0), int(w0))
        fh, fw = flow_grid_shape(h0, w0, flow_res_div)
        gray_np = np.empty((len(group), fpc, fh, fw), np.uint8)
        for i, (s, e) in enumerate(group):
            if gray is not None:  # producer-precomputed per-frame gray
                gray_np[i, :f_len] = gray[s - 1:e]
            else:
                gray_np[i, :f_len] = decode.gray_flow_grid(
                    frames[s - 1:e], fh, fw)
            if f_len < fpc:
                gray_np[i, f_len:] = gray_np[i, f_len - 1]
        tick0 = ticks_rgb - 1
        clip_rgb = np.stack([frame_gather(s - 1 + tick0)
                             for s, _e in group])
        if cfg.host_crop:
            b_, t_ = clip_rgb.shape[:2]
            clip_rgb = decode.resize_crop_frames(
                clip_rgb.reshape((b_ * t_,) + clip_rgb.shape[2:]),
                cfg.frame_resize, cfg.crop_size,
            ).reshape(b_, t_, cfg.crop_size, cfg.crop_size, 3)
            if cfg.host_yuv420:
                cs = cfg.crop_size
                clip_rgb = decode.bgr_to_yuv420(
                    clip_rgb.reshape(b_ * t_, cs, cs, 3),
                ).reshape(b_, t_, cs * 3 // 2, cs)
    else:
        clip_rgb = np.stack([frame_range(s - 1, e)
                             for s, e in group])      # [B,F,H,W,3]
        if f_len < cfg.frames_per_clip:
            # pad tail clips with last-frame repeats: one geometry per
            # batch size; plans never index the padding
            rep = np.repeat(clip_rgb[:, -1:],
                            cfg.frames_per_clip - f_len, axis=1)
            clip_rgb = np.concatenate([clip_rgb, rep], axis=1)
    return BatchPayload(list(nums), f_len, clip_rgb, gray_np, native_hw)


def stream_payloads(path: str, cfg: ExtractionConfig, flow_res_div: int,
                    new_size: tuple[int, int] | None) -> Iterator[BatchPayload]:
    """Decode a video and yield upload payloads batch by batch, holding only
    a constant window of frames (runs in decode worker processes,
    pipeline/mpstream.py, and on the producer thread of
    Extractor.extract_video_stream).

    Streams only FULL clip batches while decoding; the tail (and any full
    clips a wrong container count hid) is replanned from the ACTUAL decoded
    frame count: container counts are duration*fps estimates for some mp4s
    and must not decide clip boundaries. Clip BOUNDARIES are
    count-independent (clip i spans frames [i*fpc, (i+1)*fpc)), but batch
    GROUPING is not, so the replan regroups only the clips not already
    emitted (their frames all sit past the freed prefix: emitted clips are
    a prefix of the full-clip list)."""
    total = decode.probe_frame_count(path)
    usable = max(total - 1, 0)  # first decoded frame skipped (decode.py)
    fpc = cfg.frames_per_clip
    frames: list[np.ndarray | None] = []
    grays: list[np.ndarray] | None = [] if cfg.host_gray else None
    grid = None
    freed = 0
    done_clips: set[int] = set()
    # full-batch plan from the container estimate, consumed as frames arrive
    pending = [(g, nums) for g, nums in plan_groups(usable, cfg)
               if all(e - s + 1 == fpc for s, e in g)] if usable else []
    pi = 0
    for f in decode.video_frames(path, new_size):
        if grays is not None:
            if grid is None:
                grid = flow_grid_shape(f.shape[0], f.shape[1], flow_res_div)
            grays.append(decode.gray_flow_grid(f[None], *grid)[0])
        frames.append(f)
        while pi < len(pending):
            group, nums = pending[pi]
            need = max(e for _s, e in group)
            if len(frames) < need:
                break
            yield build_payload(frames, grays, group, nums, cfg,
                                flow_res_div)
            done_clips.update(nums)
            # later groups only touch indices >= need (ranges are disjoint
            # and monotonic; flow pairs never cross a clip boundary)
            for j in range(freed, need):
                frames[j] = None
                if grays is not None:
                    grays[j] = None
            freed = need
            pi += 1
    actual = len(frames)
    if actual == 0:
        raise IOError(f"no frames decoded from {path!r}")
    if actual < usable:
        log.warning("%s: decoded %d < reported %d frames", path, actual,
                    usable)
    remaining = [(r, n) for group, nums in plan_groups(actual, cfg)
                 for r, n in zip(group, nums) if n not in done_clips]
    full = [(r, n) for r, n in remaining if r[1] - r[0] + 1 == fpc]
    tails = [(r, n) for r, n in remaining if r[1] - r[0] + 1 != fpc]
    bsz = cfg.batch_clips
    for batch in ([full[i:i + bsz] for i in range(0, len(full), bsz)]
                  + [[tl] for tl in tails]):
        yield build_payload(frames, grays, [r for r, _ in batch],
                            [n for _, n in batch], cfg, flow_res_div)
