"""K1's share of its roofline in a batched top-k query, in %.

Numerator: the least time of a batch's work at the published peaks
(``benchmark/stats.py``) times the batches traced: the index features and
mask read once, the Q f32 targets and weights read once, the [Q, k] values
and ids written once; its operations, 2 Q S K N D, are the smaller bound.
Denominator: the device time of every operation launched inside the
``bench.query`` ranges (K1, the top-k and the read-back), whatever
implements them.
"""

from benchmark import stats

STAGE = "query"


def work_bytes(w: dict) -> float:
    n, d, m, q = w["n_padded"], w["dim"], w["members"], w["q"]
    return (m * n * d * w["feat_bytes"] + m * n + q * m * d * 4 + q * w["streams"] * 4
            + q * w["k"] * (4 + 8))


def work_flops(w: dict) -> float:
    return 2.0 * w["q"] * w["members"] * w["n_padded"] * w["dim"]


def read(run):
    busy = run.trace.stage_busy_s.get(STAGE)
    batches = run.work.get("batches", 0)
    if not busy or not batches:
        return None
    least = stats.least_time_s(work_flops(run.work), work_bytes(run.work))
    return 100.0 * least * batches / busy
