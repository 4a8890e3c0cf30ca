"""Host-side video decode (cv2) feeding the device pipeline.

A copy of ``videoquery/pipeline/decode.py`` (numpy and cv2 only: decode
worker processes import it, and it imports no torch): whole-video and
seek-based parallel decode, the compact-upload helpers (the uint8 gray at
the flow grid, the host resize+crop, YUV 4:2:0) and the synthetic test
clip. The reference skips the first decoded frame ("skip the initial blank
frame", build_wof_clips.py:32), so frame 1 here is the second decoded
frame, keeping frame indices aligned with reference clip boundaries.
"""

from __future__ import annotations

import logging
from typing import Iterator

import numpy as np

log = logging.getLogger(__name__)


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


def video_fps(path: str) -> float:
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return fps or 15.0


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


def to_grayscale(frames: np.ndarray) -> np.ndarray:
    """BGR uint8 [N, H, W, 3] -> float32 [N, H, W] in [0, 1] (ITU-R 601,
    matching cv2.cvtColor BGR2GRAY coefficients)."""
    f = frames.astype(np.float32)
    gray = 0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]
    return gray / 255.0


def _box_factor(h: int, w: int, fh: int, fw: int) -> int:
    """Largest integer k with h%k == w%k == 0 and h//k >= fh, w//k >= fw —
    the exact box-downscale prefactor cv2's INTER_AREA fast path accepts."""
    k = 1
    f = 2
    while h % (k * f) == 0 and w % (k * f) == 0 \
            and h // (k * f) >= fh and w // (k * f) >= fw:
        k *= f
    return k


def gray_flow_grid(frames: np.ndarray, fh: int, fw: int,
                   interp: str = "area2") -> np.ndarray:
    """BGR uint8 [N, H, W, 3] -> uint8 gray [N, fh, fw] at the flow grid
    (extract.flow_grid_shape), computed with cv2 on the host.

    This is the compact-upload companion of the on-device gray path: uint8
    gray is exactly what the reference's dense_flow consumed (its inputs
    were cv2 gray JPEGs, build_wof_clips.py:60-73), so the 8-bit
    quantization is parity with the reference rather than a loss.

    interp — all antialiased-downscale variants except "linear":
    - "area2" (production default): exact integer box downscale first
      (cv2's SIMD fast path), then INTER_AREA for the residual non-integer
      factor. Faster than direct INTER_AREA (the gray is the largest
      host-producer cost) and gated EPE/retrieval-equal to "area" for the
      JAX package (its tools/flow_quality.py --host_gray, docs/TUNING.md).
    - "area": direct cv2 INTER_AREA (the round-2 gated default).
    - "linear": cv2's 2-tap INTER_LINEAR (gated WORSE bg EPE; not
      production)."""
    import cv2

    out = np.empty((len(frames), fh, fw), np.uint8)
    if interp == "area2":
        h, w = frames.shape[1:3]
        k = _box_factor(h, w, fh, fw)
        for i, f in enumerate(frames):
            g = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
            if k > 1:
                g = cv2.resize(g, (w // k, h // k),
                               interpolation=cv2.INTER_AREA)
            if g.shape != (fh, fw):
                g = cv2.resize(g, (fw, fh), interpolation=cv2.INTER_AREA)
            out[i] = g
        return out
    mode = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR}[interp]
    for i, f in enumerate(frames):
        g = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
        out[i] = cv2.resize(g, (fw, fh), interpolation=mode)
    return out


def resize_crop_frames(frames: np.ndarray, resize_wh: tuple[int, int],
                       crop_size: int, where: str = "center") -> np.ndarray:
    """BGR uint8 [N, H, W, 3] -> uint8 [N, crop, crop, 3]: cv2 INTER_LINEAR
    resize to (W, H) followed by a fixed crop, on the host.

    Companion of ExtractionConfig.host_crop: the reference performs exactly
    this uint8 cv2 resize inside predict_single_frame (calcSig_wOF.py:94)
    before cropping, so the host path is the parity-normative one; the
    device float path (preprocess._resize_crop) matches it to cv2's
    fixed-point rounding (<= ~1.5 LSB, tests/test_pipeline.py). When frames
    already sit at (W, H) — decode_at_target — the resize is skipped and
    this is pure slicing, bit-identical to the device path."""
    import cv2

    w, h = resize_wh
    if where == "center":
        top, left = (h - crop_size) // 2, (w - crop_size) // 2
    elif where == "tl":
        top, left = 0, 0
    else:
        raise ValueError(f"unknown crop {where!r}")
    out = np.empty((len(frames), crop_size, crop_size, 3), np.uint8)
    for i, f in enumerate(frames):
        if f.shape[0] != h or f.shape[1] != w:
            f = cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
        out[i] = f[top:top + crop_size, left:left + crop_size]
    return out


def bgr_to_yuv420(frames: np.ndarray) -> np.ndarray:
    """BGR uint8 [N, H, W, 3] -> I420 uint8 [N, H*3//2, W]
    (cv2 COLOR_BGR2YUV_I420: Y plane, then the 2x2-subsampled U and V
    planes packed row-major). Companion of ExtractionConfig.host_yuv420 —
    halves the chroma payload of the tick-frame upload; the device inverse
    (extract._yuv420_to_bgr) matches cv2's own YUV2BGR_I420 to <=2 LSB.
    Chroma subsampling is the reference's own data path: every rgb frame
    it scored went through a 4:2:0 JPEG (build_wof_clips.py:47,
    calcSig_wOF.py:92-93)."""
    import cv2

    n, h, w = frames.shape[:3]
    out = np.empty((n, h * 3 // 2, w), np.uint8)
    for i, f in enumerate(frames):
        out[i] = cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420)
    return out


def probe_frame_count(path: str) -> int:
    """Container-reported frame count (0 if unknown)."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    cap.release()
    return max(n, 0)


def _decode_range(path, start, count, new_size):
    """Decode `count` frames starting at decoded index `start` (seek-based).
    Returns fewer frames at EOF."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if start:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start)
            if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) != start:
                raise IOError(f"seek to frame {start} failed for {path!r}")
        out = []
        for _ in range(count):
            ok, frame = cap.read()
            if not ok:
                break
            if new_size:
                frame = cv2.resize(frame, new_size)
            out.append(frame)
        return out
    finally:
        cap.release()


def load_video_parallel(path: str, new_size: tuple[int, int] | None = None,
                        workers: int | None = None,
                        chunk: int = 300) -> np.ndarray:
    """Multi-worker seek-based decode -> [N, H, W, 3] BGR uint8.

    The reference parallelized decode across videos with a process pool
    (build_wof_clips.py:181-184); on a many-core host a SINGLE long video
    must also decode in parallel to keep up with the device (one cv2 thread
    decodes a few hundred frames a second). Chunked seeks are verified frame-exact against the sequential
    reader in tests; falls back to sequential when the container does not
    report a frame count or seeking fails. Returns the same frames as
    load_video (first decoded frame skipped)."""
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    workers = workers or min(16, _os.cpu_count() or 1)
    total = probe_frame_count(path)
    if workers <= 1 or total < 2 * chunk or total <= 1:
        return load_video(path, new_size)
    usable = total - 1  # the reference skips the first decoded frame
    starts = list(range(1, total, chunk))

    def decode_chunk(s):
        # Decode one extra LEADING frame (s-1): FFmpeg echoes the requested
        # CAP_PROP_POS_FRAMES even when the actual decode position is
        # keyframe/time-approximate (VFR mp4s), so a positional check cannot
        # detect a misaligned seek. Instead each chunk re-decodes its left
        # neighbor's last frame and the stitcher compares the bytes — a
        # shifted chunk can no longer pass silently.
        # The LAST chunk reads to EOF: containers may under-report their
        # frame count (duration*fps estimates), and those trailing frames
        # must not be silently dropped relative to load_video.
        count = chunk if s + chunk < total else 1 << 30
        frames = _decode_range(path, s - 1, count + 1, new_size)
        return frames[0] if frames else None, frames[1:]

    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            parts = list(pool.map(decode_chunk, starts))
    except Exception as exc:  # noqa: BLE001 — cv2 raises cv2.error, not IOError
        log.warning("chunked decode failed for %s (%s); sequential fallback",
                    path, exc)
        return load_video(path, new_size)
    for i in range(1, len(parts)):
        overlap = parts[i][0]
        prev = parts[i - 1][1]
        if overlap is None or not prev or not np.array_equal(overlap, prev[-1]):
            log.warning("chunked decode of %s misaligned at boundary %d; "
                        "sequential fallback", path, i)
            return load_video(path, new_size)
    frames = [f for _, part in parts for f in part]
    if len(frames) < usable:
        log.warning("chunked decode of %s returned %d/%d frames; "
                    "sequential fallback", path, len(frames), usable)
        return load_video(path, new_size)
    return np.stack(frames)
