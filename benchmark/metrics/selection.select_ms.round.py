"""Host ms a poll group in selection: the program's ``selection`` span
(search/selection.py::select_clips_to_review, once a query).
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("selection",), "host_ms", "poll_groups")
