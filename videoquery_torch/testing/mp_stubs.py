"""Synthetic payload producers for exercising the multi-process streaming
dispatcher (pipeline/mpstream.py) without video files or spare cores: a
copy of videoquery/testing/mp_stubs.py for the port's tests.

The production payload producer is decode-bound (cv2, CPU); these stubs
model it with time.sleep — sleeps overlap perfectly across worker
processes even on a single-core host, so aggregate-producer SCALING is
testable in CI (tests/test_mpstream.py::test_throttled_producers_scale).

Path grammar: "throttle:<n_payloads>:<delay_seconds>[:die|:fail]"
  die  — exit the worker process abruptly mid-video (simulates a cv2
         segfault/OOM-kill: no error message is ever posted)
  fail — raise (the ordinary per-video error path)
"""

from __future__ import annotations

import os
import time


def throttled_payloads(path: str, cfg, flow_res_div, new_size):
    parts = path.split(":")
    assert parts[0] == "throttle", path
    n, delay = int(parts[1]), float(parts[2])
    mode = parts[3] if len(parts) > 3 else ""
    for i in range(n):
        time.sleep(delay)
        if mode == "die" and i == n // 2:
            os._exit(17)
        if mode == "fail" and i == n // 2:
            raise RuntimeError("synthetic decode failure")
        yield {"path": path, "i": i, "pid": os.getpid()}
