"""Stream us a flow pair: the program's ``extract.flow`` spans (the gray at
the flow grid, the camera and TV-L1 of the pairs on K3 and K2, the rescue's
choice queued), read from their CUDA events, over the pairs its
``extract.flow_pairs`` counter says they solved (TSN: the pairs its tick
stacks use; I3D: every consecutive pair). The stream's idle time between
the events is counted too.
"""

from benchmark import spans


def read(run):
    pairs = spans.counter("extract.flow_pairs", "extract.flow")
    if not pairs:
        return None
    total = spans.record().totals()["extract.flow"]["device_ms"]
    return None if total is None else 1e3 * total / pairs
