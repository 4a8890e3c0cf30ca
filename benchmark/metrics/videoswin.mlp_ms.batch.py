"""Stream ms a batch of Video Swin's MLPs: the program's ``videoswin.mlp``
spans (each block's norm2, fc1, GELU, fc2 and the residual add over all
views of the batch), read from their CUDA events. The stream's idle time
between the events is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("videoswin.mlp",), "device_ms", "batches")
