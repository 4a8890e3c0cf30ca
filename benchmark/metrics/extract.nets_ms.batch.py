"""Stream ms a batch of the two streams' networks: the program's
``extract.rgb_net`` and ``extract.flow_net`` spans (the inputs, T1, cuDNN,
the pools and casts of 2 x K BN-Inception ensembles; the flow stream's span
also holds the rescue's re-solve and the quantized stacks), read from their
CUDA events. The stream's idle time between the events is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("extract.rgb_net", "extract.flow_net"), "device_ms", "batches")
