"""Host ms a poll group in the optimizer's fetch: the program's
``optimizer.fetch`` span (the reviewed rows gathered on the card and
downloaded).
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("optimizer.fetch",), "host_ms", "poll_groups")
