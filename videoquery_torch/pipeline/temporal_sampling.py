"""The transformers' frame sampling at test time (numpy only).

PySlowFast (which TimeSformer's code runs on) samples a clip's frames with
``temporal_sampling``: ``torch.linspace(start, end, num_samples)``,
clamped to the clip and truncated to int. Over the system's whole segment
the start is frame 0 and the end its last frame. ``linspace_frames``
repeats that rule without torch, so the decode workers can build the
payload with numpy alone: float32 arithmetic in the order torch's CPU
``linspace`` uses (``start + step * i`` for the first half of the
indices, ``end - step * (steps - 1 - i)`` for the rest). A float64
linspace would truncate a few positions one frame lower where the exact
value is a whole number.

Video Swin's test protocol samples with mmaction2's ``SampleFrames`` in
test mode: ``num_clips`` clips of ``clip_len`` frames ``frame_interval``
apart, clip i starting at ``int(i * avg + avg / 2)`` with ``avg = (F -
clip_len * frame_interval + 1) / num_clips`` (at 0 when the segment is
shorter than one clip's span), each index taken mod F
(``out_of_bound_opt='loop'``). ``view_frames`` gives the segment's
distinct sampled frames, which the payload carries, and each view frame's
position among them.
"""

from __future__ import annotations

import numpy as np


def linspace_frames(frame_cnt: int, num_samples: int) -> np.ndarray:
    """0-based int64 [num_samples] frame indices of a clip of frame_cnt
    frames: PySlowFast's ``temporal_sampling`` over the whole clip."""
    if num_samples == 1:
        pos = np.zeros(1, np.float32)
    else:
        start, end = np.float32(0), np.float32(frame_cnt - 1)
        step = (end - start) / np.float32(num_samples - 1)
        i = np.arange(num_samples)
        pos = np.where(i < num_samples // 2, start + step * i.astype(np.float32),
                       end - step * (num_samples - 1 - i).astype(np.float32)).astype(np.float32)
    return np.clip(pos, 0, frame_cnt - 1).astype(np.int64)


def multiview_frames(frame_cnt: int, clip_len: int, frame_interval: int,
                     num_clips: int) -> np.ndarray:
    """0-based int64 [num_clips, clip_len] frame indices of a segment of
    frame_cnt frames: mmaction2's test-mode ``SampleFrames``."""
    span = clip_len * frame_interval
    if frame_cnt > span - 1:
        avg = (frame_cnt - span + 1) / float(num_clips)
        offsets = (np.arange(num_clips) * avg + avg / 2.0).astype(np.int64)
    else:
        offsets = np.zeros(num_clips, np.int64)
    index = offsets[:, None] + np.arange(clip_len)[None, :] * frame_interval
    return np.mod(index, frame_cnt)


def view_frames(frame_cnt: int, clip_len: int, frame_interval: int,
                num_clips: int) -> tuple[np.ndarray, np.ndarray]:
    """(distinct, positions): the sorted distinct frames [U] that
    ``multiview_frames`` samples, and [num_clips, clip_len] positions into
    them, so that ``distinct[positions]`` is its index."""
    index = multiview_frames(frame_cnt, clip_len, frame_interval, num_clips)
    distinct, positions = np.unique(index, return_inverse=True)
    return distinct, positions.reshape(index.shape).astype(np.int64)
