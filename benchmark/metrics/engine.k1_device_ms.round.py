"""Stream ms a poll group of K1's pass: the program's ``kernels.k1`` spans
inside ``engine.similarity`` (SearchEngine.compute_similarities_multi),
read from their CUDA events, with no synchronise added. The span holds
K1's launches alone (the targets' cast is queued before it), so the only
idle time between its events is the launch's own latency.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("kernels.k1",), "device_ms", "poll_groups",
                        inside="engine.similarity")
