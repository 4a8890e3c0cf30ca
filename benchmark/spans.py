"""The program's own spans and counters of a traced run, as the per-layer
metrics read them.

``videoquery_torch.core.profiling`` records a span or a counter only while
a ``torch.profiler`` trace is on, so a ``--trace 1`` run's record holds the
traced window alone (the cell warms up untraced). A span's host ms is its
wall-clock length, with no synchronise added. Its stream ms is the time
between two CUDA events the span records on the device's stream, read
after the window: the stream's work inside the span and any time the
stream sat idle between the events, waiting for the host to queue that
work (the unit ``stream_ms`` says so). Every reading is None where the
program records no such span or counter (a program without the recorder
included), where a span has no device events (a CPU run), or where the
window completed no unit of work.
"""

from __future__ import annotations


def record():
    """The newest traced window's record, or None."""
    try:
        from videoquery_torch.core.profiling import trace_record
    except ImportError:
        return None
    return trace_record()


def ms_per(run, names: tuple[str, ...], kind: str, unit: str,
           inside: str | None = None) -> float | None:
    """The spans ``names``' summed ``kind`` ("host_ms" or "device_ms") over
    the window, a unit of work (``run.work[unit]``); with ``inside``, only
    the spans whose parent span has that name."""
    rec = record()
    n = run.work.get(unit, 0)
    if rec is None or not n:
        return None
    parents = {s.id: s.name for s in rec.spans}
    total, seen = 0.0, set()
    for s in rec.spans:
        if s.name not in names or (inside is not None and parents.get(s.parent) != inside):
            continue
        value = s.device_ms if kind == "device_ms" else s.host_ms
        if value is None:
            return None
        total += value
        seen.add(s.name)
    return total / n if seen == set(names) else None


def counter(name: str, root: str):
    """The counter ``name`` over the window: 0 where it counted nothing
    though the span ``root`` ran (the program records the layer); None
    where ``root`` never ran."""
    rec = record()
    if rec is None or root not in rec.totals():
        return None
    return rec.counters.get(name, 0)
