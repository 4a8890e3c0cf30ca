"""Stream ms a batch of TimeSformer's time attention: the program's
``timesformer.time_attn`` spans (each block's ``temporal_norm1``, qkv, the
attention over the 96 frames of each patch site, proj, ``temporal_fc`` and
the residual add), read from their CUDA events. The stream's idle time
between the events is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("timesformer.time_attn",), "device_ms", "batches")
