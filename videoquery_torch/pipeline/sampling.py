"""Frame-tick sampling and clip segmentation.

A copy of ``videoquery/pipeline/sampling.py`` (numpy only) for the port.

Reproduces the reference's sampling arithmetic exactly:

- ticks: 25 evenly spaced frames per clip regardless of clip length
  (calcSig_wOF.py:67-72). The reference runs under Python 2, where
  `(frame_cnt - stack_depth) / (num-1)` is *floor* division — mirrored here.
- clips: fps*clip_time frames per clip; trailing remainder kept iff at least
  2 seconds (build_wof_clips.py:78-128).
"""

from __future__ import annotations

import numpy as np


def frame_ticks(frame_cnt: int, num_ticks: int = 25, stack_depth: int = 1
                ) -> np.ndarray:
    """1-based frame indices to sample (calcSig_wOF.py:67-72).

    step = floor((frame_cnt - stack_depth) / (num_ticks - 1)); short clips
    (step <= 0) sample frame 1 num_ticks times."""
    step = (frame_cnt - stack_depth) // (num_ticks - 1)
    if step > 0:
        ticks = np.arange(1, min(2 + step * (num_ticks - 1), frame_cnt + 1), step)
    else:
        ticks = np.ones(num_ticks, np.int64)
    assert len(ticks) == num_ticks, (frame_cnt, num_ticks, stack_depth)
    return ticks.astype(np.int64)


def flow_stack_indices(tick: int, frame_cnt: int, stack_depth: int = 5
                       ) -> np.ndarray:
    """Frame indices of one flow stack: tick..tick+depth-1 clamped to the
    clip end (calcSig_wOF.py:104)."""
    return np.minimum(np.arange(tick, tick + stack_depth), frame_cnt)


def flow_stack_index_matrix(frame_cnt: int, num_ticks: int = 25,
                            stack_depth: int = 5) -> np.ndarray:
    """0-based [num_ticks, stack_depth] flow-frame indices for every tick —
    the single definition of the clamping rule used by the extractor, bench
    and tools."""
    ticks = frame_ticks(frame_cnt, num_ticks, stack_depth)
    return np.minimum(
        ticks[:, None] + np.arange(stack_depth)[None, :], frame_cnt
    ) - 1


def flow_pair_plan(frame_cnt: int, num_ticks: int = 25,
                   stack_depth: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """(pair_idx i32[P], stack_pos i32[T, D]): the unique flow frame pairs
    the tick stacks actually consume, plus each stack slot's position in
    that list. Flow frame i is flow(i -> i+1); the final frame duplicates
    the previous flow (build_wof_clips.py:84-100 layout), realized by
    clamping the source pair to frame_cnt-2. Computing only these P pairs
    (125 of 149 at the 150-frame default) skips ~16% of TV-L1 work."""
    stack_idx = flow_stack_index_matrix(frame_cnt, num_ticks, stack_depth)
    clamped = np.minimum(stack_idx, max(frame_cnt - 2, 0))
    pair_idx, inverse = np.unique(clamped, return_inverse=True)
    return (pair_idx.astype(np.int32),
            inverse.reshape(stack_idx.shape).astype(np.int32))


def dense_plan(frame_cnt: int) -> tuple[np.ndarray, np.ndarray]:
    """I3D's dense sampling of a clip (no counterpart in the JAX package):
    (frames i64[F], pair_idx i32[F-1]), 0-based: every frame, the rgb
    volume, and every consecutive pair (f, f+1), the flow volume."""
    return (np.arange(frame_cnt, dtype=np.int64),
            np.arange(max(frame_cnt - 1, 0), dtype=np.int32))


def flow_warm_plan(pair_idx: np.ndarray, group: int = 5
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Temporal warm-start plan over a pair list (VERDICT r2 #2).

    Consecutive frame pairs have highly correlated flow; instead of solving
    every pair's full TV-L1 pyramid from zero, solve a sparse set of
    KEYFRAME pairs fully and initialize the rest from their nearest
    keyframe's solution, refining only the finest level. Both phases stay
    fully batched (no sequential chain): keys first, then all warm pairs at
    once.

    pair_idx is split into maximal runs of consecutive frame indices (the
    tick stacks produce runs of ~stack_depth); within each run one key is
    placed per `group` pairs, at block centers so no warm pair sits more
    than ~group/2 frames from its key.

    Returns (key_pos i32[K], warm_pos i32[P-K], warm_src i32[P-K]):
    positions into pair_idx; warm pair j initializes from the flow of key
    number warm_src[j] (an index into key_pos's order)."""
    p = np.asarray(pair_idx)
    n = len(p)
    if n == 0 or group <= 1:
        return (np.arange(n, dtype=np.int32),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
    run_starts = [0] + [i for i in range(1, n) if p[i] != p[i - 1] + 1] + [n]
    key_pos, warm_pos, warm_src = [], [], []
    for a, b in zip(run_starts[:-1], run_starts[1:]):
        r = b - a
        n_keys = -(-r // group)
        keys_here = [a + min(group // 2 + i * group, r - 1)
                     for i in range(n_keys)]
        base_key = len(key_pos)
        key_pos.extend(keys_here)
        for pos in range(a, b):
            if pos in keys_here:
                continue
            nearest = int(np.argmin([abs(pos - k) for k in keys_here]))
            warm_pos.append(pos)
            warm_src.append(base_key + nearest)
    return (np.asarray(key_pos, np.int32), np.asarray(warm_pos, np.int32),
            np.asarray(warm_src, np.int32))


def clip_ranges(n_frames: int, fps: int = 15, clip_seconds: int = 10,
                min_tail_seconds: int = 2) -> list[tuple[int, int]]:
    """[(start_frame, end_frame)] 1-based inclusive ranges per clip
    (build_wof_clips.py:78-128): full clips of fps*clip_seconds frames, plus
    a trailing clip iff the remainder is at least min_tail_seconds long."""
    per_clip = fps * clip_seconds
    n_clips = n_frames // per_clip
    ranges = [(i * per_clip + 1, (i + 1) * per_clip) for i in range(n_clips)]
    remainder = n_frames - n_clips * per_clip
    if remainder >= min_tail_seconds * fps:
        ranges.append((n_clips * per_clip + 1, n_frames))
    return ranges
