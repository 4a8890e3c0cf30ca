"""Host ms a poll group in the selection (select_clips_to_review over the group's queries).

The sum of the traced window's ``bench.selection`` ranges over the poll
groups completed in it; in a traced run each stage ends with a
synchronise, so the range holds the stage's device work too.
"""

STAGE = "selection"


def read(run):
    spans = run.trace.stage_host_s.get(STAGE)
    groups = run.work.get("poll_groups", 0)
    if not spans or not groups:
        return None
    return sum(spans) / groups * 1e3
