"""Stage ranges around calls into the program, and the reading of a trace.

A traced run (``--trace 1``) wraps the window in a ``torch.profiler``
trace of the CPU and the card. Each call into a layer of the program runs
inside a ``record_function`` range named ``bench.<stage>`` that the loop
opens (``Stages``); in a traced run every stage ends with a synchronise,
so that its host range holds its own device work. An untraced run opens no
range and adds no synchronise.

``reduce_events`` reads the exported Chrome trace (written under
``TMPDIR``, deleted once read): the device's busy time inside the window,
each device operation's stage (the host range open when it was launched),
each stage's host time, the device operations that took most time by
stage and name, and the longest idle gaps with the stage the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

WINDOW = "bench.window"
PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


class Stages:
    """``with stages("name"):`` around a call into a layer. Untraced it
    does nothing; traced it opens ``bench.name`` and, unless ``sync`` is
    false (a queued loop), synchronises the device at the end of the
    stage."""

    def __init__(self, traced: bool, sync=None):
        self.traced = traced
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = True):
        if not self.traced:
            yield
            return
        from torch.profiler import record_function

        with record_function(PREFIX + name):
            yield
            if sync and self.sync is not None:
                self.sync()


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    stage_host_s: dict[str, list[float]]   # each occurrence's host duration
    stage_busy_s: dict[str, float]         # device busy time launched in it
    device_ops: list[list]                 # ["stage: name", seconds], most first
    idle_gaps: list[list]                  # [stage, seconds], longest first

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


class _Ranges:
    """The ``bench.*`` stage range open at a host time (the loops open
    stages one after another, never one inside another)."""

    def __init__(self, ranges: list[tuple[float, float, str]]):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: float) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.ranges[i][1]:
            return self.ranges[i][2]
        return None


def reduce_events(events: list[dict]) -> TraceSummary:
    """The summary of a Chrome trace's events (``traceEvents``)."""
    window = None
    ranges = []
    launches: dict[int, float] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            if name == WINDOW:
                window = (ts, ts + dur)
            else:
                ranges.append((ts, ts + dur, name[len(PREFIX):]))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            device.append((ts, dur, name, e.get("args", {}).get("correlation")))
    if window is None:
        raise ValueError("the trace holds no bench.window range")
    w0, w1 = window
    stage_of = _Ranges(ranges)
    stage_host: dict[str, list[float]] = {}
    for a, b, name in ranges:
        stage_host.setdefault(name, []).append((b - a) / 1e6)
    per_stage: dict[str, list[tuple[float, float]]] = {}
    by_name: dict[str, float] = {}
    clipped = []
    for ts, dur, name, corr in device:
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        launch = launches.get(corr)
        stage = (stage_of.at(launch) if launch is not None else None) or "(no stage)"
        per_stage.setdefault(stage, []).append((a, b))
        key = f"{stage}: {name}"
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
    busy = _union(clipped)
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b > a:
            gaps.append((b - a, a))
    gaps.sort(reverse=True)
    idle = [[stage_of.at(a) or "(between stages)", g / 1e6] for g, a in gaps[:TOP]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=_length(busy) / 1e6,
        stage_host_s=stage_host,
        stage_busy_s={k: _length(_union(v)) / 1e6 for k, v in per_stage.items()},
        device_ops=[[n[:160], s] for n, s in ops],
        idle_gaps=idle)


@contextlib.contextmanager
def traced_window(device):
    """Profile the CPU and the card around the block, inside a
    ``bench.window`` range that ends once the device is done; yields a
    holder whose ``summary`` is set once the trace has been read. On a CPU
    device (the tests) only the CPU is traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = _Holder()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield holder
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="benchmark_trace_", suffix=".json",
                                dir=os.environ.get("TMPDIR") or None)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    holder.summary = reduce_events(events)


class _Holder:
    summary: TraceSummary | None = None
