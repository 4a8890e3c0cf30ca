"""Share of the downloaded candidate slots that held a clip of the band, in %.

The program's counters ``engine.band_clips`` (each used row's clips in the
band) over ``engine.band_slots`` (the candidate slots downloaded, a cap a
query and shard, again on a cap's retry), over the traced window.
"""

from benchmark import spans


def read(run):
    clips = spans.counter("engine.band_clips", "engine.band_rows")
    slots = spans.counter("engine.band_slots", "engine.band_rows")
    if clips is None or not slots:
        return None
    return 100.0 * clips / slots
