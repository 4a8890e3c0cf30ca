"""Stream ms a batch of Video Swin's window attention: the program's
``videoswin.attn`` spans (each block's norm1, the pad, roll and window
gather, qkv, the attention with its relative position bias and, in odd
blocks, the shift mask, proj, the gather back and the residual add over all
views of the batch), read from their CUDA events. The stream's idle time
between the events is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("videoswin.attn",), "device_ms", "batches")
