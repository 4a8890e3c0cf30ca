"""Stream ms a batch of I3D's Mixed blocks: the program's ``i3d.mixed``
spans of both streams (``Mixed_3b`` through ``Mixed_5c`` with the pools
between), read from their CUDA events. The stream's idle time between the
events is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("i3d.mixed",), "device_ms", "batches")
