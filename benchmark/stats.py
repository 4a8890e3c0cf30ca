"""The arithmetic of the end-to-end metrics, and the published peaks."""

from __future__ import annotations

import math

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit:
# bf16 tensor cores and HBM3 bandwidth. A share is stated against these, with
# the card's power limit beside it in the result's ``device``.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of every value: the smallest value
    with at least q% of the values at or below it. Taken over all requests
    of the window, never over chunks of them."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def least_time_s(flops: float = 0.0, nbytes: float = 0.0) -> float:
    """The least time the card could take for this work at its published
    peaks: the larger of the operations' and the bytes' bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
