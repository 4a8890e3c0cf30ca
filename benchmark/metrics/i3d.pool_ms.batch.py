"""Stream ms a batch of I3D's max pools: the program's ``i3d.pool`` spans of
both streams (13 pools a forward, each around one pool call inside
``i3d.stem`` or ``i3d.mixed``), read from their CUDA events. The stream's
idle time between the events is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("i3d.pool",), "device_ms", "batches")
