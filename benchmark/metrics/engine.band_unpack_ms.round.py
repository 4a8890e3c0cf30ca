"""Host ms a poll group in the banded unpack: the program's
``engine.band_unpack`` span (ResidentTable._unpack_banded: the f64 scores
and the dict of each query's band).
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("engine.band_unpack",), "host_ms", "poll_groups")
