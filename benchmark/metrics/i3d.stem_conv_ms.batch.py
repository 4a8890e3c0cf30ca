"""Stream ms a batch of I3D's stem conv, ``Conv3d_1a_7x7`` (7x7x7, stride
2): the program's ``i3d.stem_conv`` spans of both streams (one a forward,
inside ``i3d.stem``), read from their CUDA events. The stream's idle time
between the events is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("i3d.stem_conv",), "device_ms", "batches")
