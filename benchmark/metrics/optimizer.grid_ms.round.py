"""Host ms a poll group in the optimizer's grid: the program's
``optimizer.grid`` span (the f64 weight and threshold grid and the parabola
of each query, on the host).
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("optimizer.grid",), "host_ms", "poll_groups")
