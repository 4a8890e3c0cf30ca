"""Host-side video decode (cv2) feeding the device pipeline.

A copy of the parts of ``videoquery/pipeline/decode.py`` that the port
calls: whole-video decode and the synthetic test clip. The reference skips
the first decoded frame ("skip the initial blank frame",
build_wof_clips.py:32), so frame 1 here is the second decoded frame, keeping
frame indices aligned with reference clip boundaries. The compact-upload
helpers (host gray flow grid, host resize+crop, YUV 4:2:0) and the parallel
decode are not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def video_frames(
    path: str,
    new_size: tuple[int, int] | None = None,  # (W, H), like --new_width/height
    skip_first: bool = True,
) -> Iterator[np.ndarray]:
    """Yield BGR uint8 frames [H, W, 3]."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path!r}")
    if skip_first:
        ok, _ = cap.read()
        if not ok:
            raise IOError(f"empty video {path!r}")
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if new_size:
            frame = cv2.resize(frame, new_size)
        yield frame
    cap.release()


def load_video(path: str, new_size: tuple[int, int] | None = None,
               max_frames: int | None = None) -> np.ndarray:
    """Decode a whole video into [N, H, W, 3] BGR uint8."""
    frames = []
    for i, f in enumerate(video_frames(path, new_size)):
        if max_frames is not None and i >= max_frames:
            break
        frames.append(f)
    if not frames:
        raise IOError(f"no frames decoded from {path!r}")
    return np.stack(frames)


def synthesize_video(path: str, n_frames: int = 160, size: tuple[int, int] = (320, 240),
                     fps: int = 15, seed: int = 0) -> str:
    """Write a synthetic moving-texture mp4 for tests and demos."""
    import cv2

    rng = np.random.default_rng(seed)
    w, h = size
    base = rng.integers(0, 255, (h * 2, w * 2, 3), np.uint8)
    base = cv2.GaussianBlur(base, (31, 31), 8)
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    if not writer.isOpened():
        raise IOError("cv2.VideoWriter failed to open (mp4v codec missing?)")
    for i in range(n_frames + 1):  # +1: decoder skips the first frame
        dx = int(2 * i) % w
        dy = int(1 * i) % h
        frame = base[dy:dy + h, dx:dx + w]
        writer.write(np.ascontiguousarray(frame))
    writer.release()
    return path
