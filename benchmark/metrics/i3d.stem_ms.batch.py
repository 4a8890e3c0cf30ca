"""Stream ms a batch of I3D's stem: the program's ``i3d.stem`` spans of
both streams (``Conv3d_1a_7x7`` through ``MaxPool3d_3a_3x3``: the 7x7x7 and
3x3x3 convs over the full-size volumes and the first pools), read from
their CUDA events. The stream's idle time between the events is counted
too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("i3d.stem",), "device_ms", "batches")
