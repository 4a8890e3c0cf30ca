"""TimeSformer's frame sampling at test time (numpy only).

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
