"""Spans, counters and device traces of the port.

``span(name, device=None)`` and ``count(name, n=1)`` mark the work of a
layer where it happens. They record only while a ``torch.profiler`` trace
is active (``torch.autograd._profiler_enabled()``): the benchmark's traced
window, ``device_trace`` below, or any profiler an operator opens.
Untraced, ``span`` returns one shared no-op context and ``count`` returns
at once: no allocation, no ``record_function``, no CUDA event, no
synchronise.

Traced, a span opens ``record_function("vq." + name)``, so it sits in the
exported Chrome trace inside its caller's ranges, on the clock of the
device operations, and records its name, its parent span and its host
start and end (``perf_counter_ns``). Given a CUDA device it also records a
timing event on the device's current stream at each end; their elapsed
time, the span's device ms, is read in ``trace_record()`` once the traced
work is done, never inside the span. A span never synchronises. The
device ms is the stream's time from the first event to the second, so it
also holds any time the stream sat idle between them, waiting for the host
to queue the span's work: a span meant to time a kernel opens right before
its launch. A span opened without ``device`` records no CUDA event and
has no device ms: its ``vq.*`` range alone marks it.

The range is enough to attribute the device's work to a span: each device
operation in the Chrome trace carries the correlation id of the launch
that queued it, and that launch lies on the host thread inside the ranges
that were open then. Read so, a span's device time is the work launched
inside it, with none of the stream's idle time in it.

A record holds one traced window: it begins where ``device_trace``
begins, or at the first span or count made with the profiler on after one
made with it off (a benchmark warms up untraced before its window).
``trace_record()`` returns the newest record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import logging
import os
import threading
import time

import torch

log = logging.getLogger(__name__)

PREFIX = "vq."

_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class SpanRecord:
    """One closed span. ``self_ms`` is its host time less the time its
    child spans cover; ``device_ms`` the stream's time between the span's
    two events, idle included (None without a CUDA device)."""

    name: str
    id: int
    parent: int | None
    start_ns: int
    end_ns: int
    self_ms: float = 0.0
    device_ms: float | None = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class TraceRecord:
    """The spans (in the order they closed) and counters of one traced
    window."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        self._pending: list[tuple[SpanRecord, torch.cuda.Event, torch.cuda.Event]] = []
        self._ids = itertools.count()

    def resolve(self) -> "TraceRecord":
        """Read the device ms of the spans closed since the last call
        (waiting for their end events) and compute every span's self ms."""
        for rec, start, end in self._pending:
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
        self._pending = []
        covered: dict[int, int] = {}
        for s in self.spans:
            if s.parent is not None:
                covered[s.parent] = covered.get(s.parent, 0) + s.end_ns - s.start_ns
        for s in self.spans:
            s.self_ms = (s.end_ns - s.start_ns - covered.get(s.id, 0)) / 1e6
        return self

    def totals(self) -> dict[str, dict]:
        """Per span name: calls, host_ms, self_ms and device_ms (None
        unless every call has a device time)."""
        out: dict[str, dict] = {}
        for s in self.spans:
            t = out.setdefault(s.name, {"calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                                        "device_ms": 0.0})
            t["calls"] += 1
            t["host_ms"] += s.host_ms
            t["self_ms"] += s.self_ms
            t["device_ms"] = (None if t["device_ms"] is None or s.device_ms is None
                              else t["device_ms"] + s.device_ms)
        return out

    def to_json(self) -> dict:
        return {"spans": [dict(dataclasses.asdict(s), host_ms=s.host_ms) for s in self.spans],
                "totals": self.totals(), "counters": dict(self.counters)}


class _State:
    record: TraceRecord | None = None
    off = True                 # a span or count was made with the profiler off


_state = _State()
_local = threading.local()


def _current() -> TraceRecord:
    if _state.off or _state.record is None:
        _state.record = TraceRecord()
        _state.off = False
    return _state.record


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "record", "id", "parent", "range", "events", "t0")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        record = _current()
        stack = _stack()
        parent = stack[-1] if stack and stack[-1].record is record else None
        self.record = record
        self.id = next(record._ids)
        self.parent = None if parent is None else parent.id
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            self.events = (start, torch.cuda.Event(enable_timing=True))
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        _stack().pop()
        self.range.__exit__(*exc)
        rec = SpanRecord(self.name, self.id, self.parent, self.t0, t1)
        self.record.spans.append(rec)
        if self.events is not None:
            self.record._pending.append((rec,) + self.events)
        return False


def span(name: str, device: torch.device | None = None):
    """``with span(name, device):`` around a layer's work (module
    docstring). ``device``: where the work runs; a CUDA device adds the
    span's device ms."""
    if not torch.autograd._profiler_enabled():
        _state.off = True
        return _OFF
    return _Span(name, device)


def spanned(name: str, fn):
    """``fn`` with each call inside ``span(name)``; ``inspect`` still reads
    ``fn``'s own code (``__wrapped__``)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


def count(name: str, n: int = 1) -> None:
    """Add n to the counter ``name`` of the traced window; untraced, nothing."""
    if not torch.autograd._profiler_enabled():
        _state.off = True
        return
    counters = _current().counters
    counters[name] = counters.get(name, 0) + n


def trace_record() -> TraceRecord | None:
    """The newest traced window's record, its device ms read and its self
    times computed; None if nothing was ever traced."""
    record = _state.record
    return None if record is None else record.resolve()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler trace of the CPU and, when CUDA is available, the
    card, written to ``<log_dir>/trace.json`` (Chrome trace format; open in
    chrome://tracing or Perfetto; the spans are its ``vq.*`` ranges), and
    the spans, their per-name totals and the counters of the block to
    ``<log_dir>/spans.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _state.record, _state.off = TraceRecord(), False
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(trace_record().to_json(), f)
    log.info("device trace and spans written to %s", log_dir)
