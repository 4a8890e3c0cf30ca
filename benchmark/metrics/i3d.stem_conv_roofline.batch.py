"""I3D's stem conv's share of its roofline, in %.

The least time the card could take for a batch's two stem convs, both
streams over B segments (the ``Conv3d_1a_7x7`` rows of
``benchmark/flops_i3d.py``: 2 N To Ho Wo 343 Cin 64 operations at the 989
TFLOP/s bf16 peak, or the input read once, the output written once and the
weights read once at 3.35 TB/s, whichever is longer; no padded tap is
counted), times the batches completed in the traced window, over the
stream ms of the program's ``i3d.stem_conv`` spans in it. It reads the
same work whatever implements the conv.
"""

from benchmark import flops_i3d, spans, stats

STEM = "Conv3d_1a_7x7"


def least_time_s(clips: int, rgb_frames: int, hw: int) -> float:
    """A batch's stem convs at the published peaks: the rgb member over
    rgb_frames, the flow member over the rgb_frames - 1 pairs."""
    rows = flops_i3d.model(clips, rgb_frames, hw, 3) + flops_i3d.model(clips, rgb_frames - 1,
                                                                        hw, 2)
    return sum(stats.least_time_s(r[1], r[2] + r[3] + r[4]) for r in rows if r[0] == STEM)


def read(run):
    ms = spans.ms_per(run, ("i3d.stem_conv",), "device_ms", "batches")
    if not ms:
        return None
    c = run.config
    return 100.0 * least_time_s(c["batch_clips"], c["frames_per_clip"], c["crop_size"]) / (
        ms / 1e3)
