"""Stage timers and device traces.

Port of ``videoquery/core/profiling.py``: wall-clock stage timers that wait
for the device work feeding a value (``sync``), and ``device_trace``, a
``torch.profiler`` trace of the CPU and, where there is one, the card,
written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree

log = logging.getLogger(__name__)


def sync(x) -> None:
    """Wait for the device work feeding x: ``torch.cuda.synchronize`` of the
    device of x's first tensor leaf; nothing on the CPU."""
    for leaf in pytree.tree_leaves(x):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


class StageTimer:
    """Accumulates wall-clock per named stage.

    with timer.stage("flow") as h: h.value = result   # synced at exit
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        out = _StageHandle()
        try:
            yield out
        finally:
            if out.value is not None:
                sync(out.value)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n = self.counts[name]
            t = self.totals[name]
            lines.append(f"{name:24s} {t:8.3f}s total  {t / max(n, 1) * 1000:8.1f} ms/call  x{n}")
        return "\n".join(lines)

    def log_report(self) -> None:
        log.info("stage timings:\n%s", self.report())


class _StageHandle:
    """Assign `.value` inside the stage to sync on it at stage exit."""

    value = None


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler trace of the CPU and, when CUDA is available, the
    card, written to ``<log_dir>/trace.json`` (Chrome trace format; open in
    chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("device trace written to %s", path)
