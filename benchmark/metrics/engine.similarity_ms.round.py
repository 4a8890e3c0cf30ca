"""Host ms a poll group in the similarity pass (SearchEngine.compute_similarities_multi: K1's avg+counts pass).

The sum of the traced window's ``bench.engine.similarity`` ranges over the poll
groups completed in it; in a traced run each stage ends with a
synchronise, so the range holds the stage's device work too.
"""

STAGE = "engine.similarity"


def read(run):
    spans = run.trace.stage_host_s.get(STAGE)
    groups = run.work.get("poll_groups", 0)
    if not spans or not groups:
        return None
    return sum(spans) / groups * 1e3
