"""Host ms a poll group in the optimizer (optimize_many, or ResidentTable.optimize for a group of one).

The sum of the traced window's ``bench.optimizer`` ranges over the poll
groups completed in it; in a traced run each stage ends with a
synchronise, so the range holds the stage's device work too.
"""

STAGE = "optimizer"


def read(run):
    spans = run.trace.stage_host_s.get(STAGE)
    groups = run.work.get("poll_groups", 0)
    if not spans or not groups:
        return None
    return sum(spans) / groups * 1e3
