"""The arithmetic of the metrics: percentiles, byte and FLOP counts, and
the reading of a trace."""

import math

import pytest

from benchmark import flops, registry, stats, trace


def test_p95_is_over_every_request_not_over_chunks():
    # 20 chunks of 20 requests; one chunk holds every slow request
    values = [1.0] * 380 + [100.0] * 20
    assert stats.percentile(values, 95) == 1.0
    values = [1.0] * 379 + [100.0] * 21
    assert stats.percentile(values, 95) == 100.0
    chunks = [values[i:i + 20] for i in range(0, 400, 20)]
    median_of_chunk_p95 = sorted(stats.percentile(c, 95) for c in chunks)[10]
    assert median_of_chunk_p95 == 1.0      # what a median of chunks would hide


def test_nearest_rank():
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile(list(range(1, 101)), 95) == 95
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def _work(q):
    return {"n_padded": 1_000_448, "dim": 1024, "members": 6, "q": q, "feat_bytes": 2,
            "streams": 2, "k": 20}


def test_k1_round_bytes():
    m = registry.load_metric("k1_roofline.round")
    n = 1_000_448
    want = 6 * n * 1024 * 2 + 6 * n + 8 * 6 * 1024 * 4 + 2 * 8 * 2 * n * 4
    assert m.work_bytes(_work(8)) == want
    assert m.work_flops(_work(8)) == 2 * 8 * 6 * n * 1024
    # HBM-bound: 12.42 GB at 3.35 TB/s
    assert stats.least_time_s(m.work_flops(_work(8)), m.work_bytes(_work(8))) == \
        pytest.approx(want / 3.35e12)


def test_k1_query_bytes():
    m = registry.load_metric("k1_roofline.query")
    n = 1_000_448
    want = 6 * n * 1024 * 2 + 6 * n + 16 * 6 * 1024 * 4 + 16 * 2 * 4 + 16 * 20 * 12
    assert m.work_bytes(_work(16)) == want
    assert stats.least_time_s(m.work_flops(_work(16)), want) == pytest.approx(want / 3.35e12)


def test_inception_block_flops_by_hand():
    # inception_3a at 28x28 from 192 channels, one image
    hw = 28 * 28
    by_hand = 2 * hw * (192 * 64 + 192 * 64 + 9 * 64 * 64 + 192 * 64 + 9 * 64 * 96
                        + 9 * 96 * 96 + 192 * 32)
    rows = {r[0]: r[1] for r in flops.model(1, 3)}
    got = sum(v for k, v in rows.items() if k.startswith("inception_3a/"))
    assert got == by_hand


def test_batch_flops():
    one = sum(r[1] for r in flops.model(1, 3)) + sum(r[1] for r in flops.model(1, 10))
    assert flops.batch_flops(3, 8, 25) == 3 * 200 * one
    assert flops.batch_flops(3, 8, 25) == pytest.approx(5.206e12, rel=1e-3)


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction():
    events = [
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("user_annotation", "bench.a", 10, 100),
        _ev("user_annotation", "bench.b", 200, 300),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 250, 5, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 260, 5, 3),
        _ev("kernel", "k1", 30, 100, 1),
        _ev("kernel", "k2", 300, 50, 2),
        _ev("gpu_memcpy", "copy", 340, 40, 3),     # overlaps k2: counted once
        _ev("cpu_op", "aten::add", 0, 5),
    ]
    s = trace.reduce_events(events)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(180e-6)
    assert s.stage_busy_s["a"] == pytest.approx(100e-6)
    assert s.stage_busy_s["b"] == pytest.approx(80e-6)
    assert s.stage_host_s == {"a": [pytest.approx(1e-4)], "b": [pytest.approx(3e-4)]}
    assert s.device_ops[0] == ["a: k1", pytest.approx(1e-4)]
    # gaps: 0-30 (a), 130-300 (between stages, then b), 380-1000 (b until 500)
    assert s.idle_gaps[0] == ["b", pytest.approx(620e-6)]
    assert s.idle_gaps[1] == ["(between stages)", pytest.approx(170e-6)]
    assert math.isclose(sum(g for _n, g in s.idle_gaps) + s.busy_s, s.window_s)


def test_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        trace.reduce_events([_ev("kernel", "k", 0, 1, 1)])
