"""I3D's convolutions' share of their roofline, in %.

The least time the card could take for a batch's I3D, both streams over
B segments (``benchmark/flops_i3d.py``: each conv's operations at the
989 TFLOP/s bf16 peak or its compulsory bytes at 3.35 TB/s, whichever is
longer, and each pool's bytes, summed over the layers), times the batches
completed in the traced window, over the stream ms of the program's
``i3d.stem`` and ``i3d.mixed`` spans in it (the spans hold every conv and
pool of the net, and the stream's idle time between their events).
"""

from benchmark import flops_i3d, spans


def read(run):
    ms = spans.ms_per(run, ("i3d.stem", "i3d.mixed"), "device_ms", "batches")
    if not ms:
        return None
    c = run.config
    least_s = flops_i3d.batch_least_time_s(c["batch_clips"], c["frames_per_clip"],
                                           c["crop_size"])
    return 100.0 * least_s / (ms / 1e3)
