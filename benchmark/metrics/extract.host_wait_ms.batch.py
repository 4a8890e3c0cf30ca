"""Host ms a batch that the host waits for the card: the program's
``extract.rescue_wait`` span (_Rescue.resolve's wait for the rescue's
choice, the batch's one wait).
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("extract.rescue_wait",), "host_ms", "batches")
