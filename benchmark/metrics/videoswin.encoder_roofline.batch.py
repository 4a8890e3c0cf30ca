"""Video Swin's backbone's share of its roofline, in %.

The least time the card could take for a batch's matrix products and
attention cores (``benchmark/flops_videoswin.py::batch_least_time_s``:
each one's operations at the 989 TFLOP/s bf16 peak or its compulsory bytes
at 3.35 TB/s, whichever is longer, summed; the glue between them is not
counted), times the batches completed in the traced window, over the
stream ms of the program's ``videoswin.embed``, ``videoswin.attn``,
``videoswin.mlp`` and ``videoswin.merge`` spans in it (together they hold
the whole backbone but the final LayerNorm and mean, and the stream's idle
time between their events).
"""

from benchmark import flops_videoswin, spans

SPANS = ("videoswin.embed", "videoswin.attn", "videoswin.mlp", "videoswin.merge")


def read(run):
    ms = spans.ms_per(run, SPANS, "device_ms", "batches")
    if not ms:
        return None
    return 100.0 * flops_videoswin.batch_least_time_s(run.config) / (ms / 1e3)
