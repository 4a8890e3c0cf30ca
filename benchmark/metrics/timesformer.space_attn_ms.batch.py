"""Stream ms a batch of TimeSformer's space attention: the program's
``timesformer.space_attn`` spans (each block's [CLS; patches] layout of
every frame, ``norm1``, qkv, the attention over the 197 tokens of each
frame, proj, the CLS token's frame mean and the residual adds), read from
their CUDA events. The stream's idle time between the events is counted
too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("timesformer.space_attn",), "device_ms", "batches")
