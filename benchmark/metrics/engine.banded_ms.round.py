"""Host ms a poll group in the banded candidates (round_scores_many, or the table's round_scores for a group of one).

The sum of the traced window's ``bench.engine.banded`` ranges over the poll
groups completed in it; in a traced run each stage ends with a
synchronise, so the range holds the stage's device work too.
"""

STAGE = "engine.banded"


def read(run):
    spans = run.trace.stage_host_s.get(STAGE)
    groups = run.work.get("poll_groups", 0)
    if not spans or not groups:
        return None
    return sum(spans) / groups * 1e3
