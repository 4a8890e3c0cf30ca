"""Stream ms a batch of the flow: the program's ``extract.flow`` span (the
gray at the flow grid, the camera and TV-L1 of the pairs on K3 and K2, the
rescue's choice queued), read from its CUDA events. The stream's idle time
between the events, while the host queues the flow's many small launches,
is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("extract.flow",), "device_ms", "batches")
