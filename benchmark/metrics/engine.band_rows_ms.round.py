"""Host ms a poll group in the banded rows: the program's ``engine.band_rows``
span (search/engine.py::_band_rows: the core queued on the card, the host's
wait for it, the copy down and the f64 cast).
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("engine.band_rows",), "host_ms", "poll_groups")
