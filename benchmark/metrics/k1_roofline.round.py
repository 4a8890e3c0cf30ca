"""K1's share of its roofline in the rounds' similarity pass, in %.

Numerator: the least time of the pass's work at the published peaks
(``benchmark/stats.py``), a poll group times the groups traced: the index
features and mask read once, the Q f32 targets read once, the [Q, S, N]
f32 averages and i32 counts written once; its operations, 2 Q S K N D, are
the smaller bound. Denominator: the device time of every operation
launched inside the ``bench.engine.similarity`` ranges, whatever kernels
implement it.
"""

from benchmark import stats

STAGE = "engine.similarity"


def work_bytes(w: dict) -> float:
    n, d, m, q = w["n_padded"], w["dim"], w["members"], w["q"]
    return (m * n * d * w["feat_bytes"] + m * n + q * m * d * 4
            + 2 * q * w["streams"] * n * 4)


def work_flops(w: dict) -> float:
    return 2.0 * w["q"] * w["members"] * w["n_padded"] * w["dim"]


def read(run):
    busy = run.trace.stage_busy_s.get(STAGE)
    groups = run.work.get("poll_groups", 0)
    if not busy or not groups:
        return None
    least = stats.least_time_s(work_flops(run.work), work_bytes(run.work))
    return 100.0 * least * groups / busy
