"""Video Swin's attention cores' share of their roofline, in %.

The least time the card could take for a batch's 24 attention cores
(``benchmark/flops_videoswin.py::sdpa_least_time_s``: each core's
operations at the 989 TFLOP/s bf16 peak or its q, k, v and output bytes at
3.35 TB/s, whichever is longer; memory-bound at windows of 392 tokens and
heads of 32; the bias and the mask are not counted), times the batches
completed in the traced window, over the stream ms of the program's
``videoswin.sdpa`` spans in it (each opened right before one
``scaled_dot_product_attention`` call and closed right after it).
"""

from benchmark import flops_videoswin, spans


def read(run):
    ms = spans.ms_per(run, ("videoswin.sdpa",), "device_ms", "batches")
    if not ms:
        return None
    return 100.0 * flops_videoswin.sdpa_least_time_s(run.config) / (ms / 1e3)
