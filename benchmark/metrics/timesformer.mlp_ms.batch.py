"""Stream ms a batch of TimeSformer's MLPs: the program's
``timesformer.mlp`` spans (each block's ``norm2``, fc1, GELU, fc2 and the
residual add over all 18,817 tokens of each segment), read from their CUDA
events. The stream's idle time between the events is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("timesformer.mlp",), "device_ms", "batches")
