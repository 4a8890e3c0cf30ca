"""Stream ms a batch of the upload: the program's ``extract.upload`` span
(Extractor._dispatch_payload's put_tree: the host packs the payload into
one pinned buffer, then queues one copy), read from its CUDA events. The
stream's idle time between the events is counted too.
"""

from benchmark import spans


def read(run):
    return spans.ms_per(run, ("extract.upload",), "device_ms", "batches")
