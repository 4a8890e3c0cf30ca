"""I3D's max pools' share of their roofline, in %.

The least time the card could take for a batch's pools, both streams over
B segments (the pool rows of ``benchmark/flops_i3d.py``: each pool's input
read once and its output written once, at 3.35 TB/s), times the batches
completed in the traced window, over the stream ms of the program's
``i3d.pool`` spans in it.
"""

from benchmark import flops_i3d, spans, stats


def least_time_s(clips: int, rgb_frames: int, hw: int) -> float:
    """A batch's pools at the HBM peak: the rgb member over rgb_frames, the
    flow member over the rgb_frames - 1 pairs."""
    rows = flops_i3d.model(clips, rgb_frames, hw, 3) + flops_i3d.model(clips, rgb_frames - 1,
                                                                        hw, 2)
    return sum(stats.least_time_s(0.0, r[2] + r[3]) for r in rows if r[1] == 0)


def read(run):
    ms = spans.ms_per(run, ("i3d.pool",), "device_ms", "batches")
    if not ms:
        return None
    c = run.config
    return 100.0 * least_time_s(c["batch_clips"], c["frames_per_clip"], c["crop_size"]) / (
        ms / 1e3)
