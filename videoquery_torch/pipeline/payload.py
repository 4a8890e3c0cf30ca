"""Host-side batch payloads for extraction (numpy only).

A copy of ``videoquery/pipeline/payload.py``'s clip planning, flow-grid
geometry and payload build, importing the port's config (the JAX module
imports ``videoquery.core.config``, whose package pulls in jax). The
compact host-gray uploads and the streaming generator are not ported yet."""

from __future__ import annotations

import dataclasses

import numpy as np

from videoquery_torch.core.config import ExtractionConfig
from videoquery_torch.pipeline.sampling import clip_ranges


def flow_grid_shape(h0: int, w0: int, flow_res_div: int) -> tuple[int, int]:
    """(fh, fw) of the reduced flow grid for native frames of (h0, w0).
    Heights snap to multiples of 8 and widths >= 128 to multiples of 128
    (the JAX package's TPU tile rule, kept so that both packages solve flow
    on the same grid: 340x256 frames at flow_res_div=2 give 128x128)."""
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
    """Host-built upload payload for one clip batch: all frames of its
    clips, uint8 [B, fpc, H, W, 3] BGR (the compact host-gray uploads of
    the JAX package are not ported yet)."""

    nums: list[int]                    # clip numbers
    f_len: int                         # real frames per clip (tail < fpc)
    clip_rgb: np.ndarray


def build_payload(frames: np.ndarray, group, nums,
                  cfg: ExtractionConfig) -> BatchPayload:
    """The host half of a signature batch. frames: uint8 [N, H, W, 3]."""
    f_len = group[0][1] - group[0][0] + 1
    clip_rgb = np.stack([frames[s - 1:e] for s, e in group])  # [B,F,H,W,3]
    if f_len < cfg.frames_per_clip:
        # pad tail clips with last-frame repeats: one geometry per batch
        # size; plans never index the padding
        rep = np.repeat(clip_rgb[:, -1:], cfg.frames_per_clip - f_len, axis=1)
        clip_rgb = np.concatenate([clip_rgb, rep], axis=1)
    return BatchPayload(list(nums), f_len, clip_rgb)
