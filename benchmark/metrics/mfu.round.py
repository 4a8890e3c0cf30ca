"""The whole round step's share of the card's bf16 peak, in %.

The multiply-adds the step needs, 2 Q S K N D for its K1 pass (a poll group),
times the poll groups completed in the traced window, over the window and
the published 989 TFLOP/s (``benchmark/stats.py``).
"""

from benchmark import stats


def read(run):
    w = run.work
    n = w.get("poll_groups", 0)
    if not n or not run.trace.window_s:
        return None
    flops = 2.0 * w["q"] * w["members"] * w["n_padded"] * w["dim"] * n
    return 100.0 * flops / run.trace.window_s / stats.PEAK_BF16_FLOPS
