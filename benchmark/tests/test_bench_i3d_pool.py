"""The I3D cell's pool readers (``i3d.pool_ms.batch``,
``i3d.pool_roofline.batch``): their entries, their reading of the
program's ``i3d.pool`` spans, their silence on a program without them, and
the pools' compulsory bytes they divide by."""

import pytest

from benchmark import flops_i3d, registry, run, spans, stats
from benchmark.tests import _small

CELL = "extract_i3d_textured"
READERS = ("i3d.pool_ms.batch", "i3d.pool_roofline.batch")


def _record(with_pools: bool = True):
    from videoquery_torch.core.profiling import SpanRecord, TraceRecord

    rec = TraceRecord()
    spans_ = [("i3d.stem", 10.0)] * 4 + [("i3d.mixed", 20.0)] * 4
    if with_pools:
        spans_ += [("i3d.pool", 0.25)] * 52          # 13 a forward, 2 streams, 2 batches
    rec.spans = [SpanRecord(name, i, None, 0, 1_000_000, device_ms=ms)
                 for i, (name, ms) in enumerate(spans_)]
    rec.counters = {"i3d.pool_launches": 52}
    return rec


def _run():
    spec = registry.load_spec()
    config = registry.load_config(spec, registry.find_cell(spec, CELL)["config"])
    return run.Run(None, {"batches": 2, "batch_flops": 1.0}, config, {})


def test_the_pools_compulsory_bytes():
    """13 pools a stream, 7.04 GB a forward at 8 x 250 x 224x224 bf16: 4.20
    ms a batch of both streams at 3.35 TB/s."""
    reader = registry.load_metric("i3d.pool_roofline.batch")
    for frames, channels in ((250, 3), (249, 2)):
        rows = [r for r in flops_i3d.model(8, frames, 224, channels) if r[1] == 0]
        assert len(rows) == 13
        assert sum(r[2] + r[3] for r in rows) == pytest.approx(7.0387e9, rel=1e-4)
    least = reader.least_time_s(8, 250, 224)
    assert least == pytest.approx(2 * 7.03868928e9 / stats.PEAK_HBM_BYTES_PER_S)
    # the pools are a part of the net's least time
    assert least < flops_i3d.batch_least_time_s(8, 250, 224)


@pytest.mark.parametrize("name", READERS)
def test_a_pool_reader_reads_its_spans_and_is_silent_without_them(name, monkeypatch):
    spec = registry.load_spec()
    entry = registry.metric_entry(spec, name)
    assert entry["workloads"] == [CELL] and entry["moves"] == "extract_clips_per_s"
    assert entry["layer"] == "kernels"
    reader = registry.load_metric(name)
    from videoquery_torch.core.profiling import TraceRecord

    # no record, an empty one, and the parent's (stem and Mixed spans, no pools)
    for rec in (None, TraceRecord(), _record(with_pools=False)):
        monkeypatch.setattr(spans, "record", lambda rec=rec: rec)
        assert reader.read(_run()) is None
    monkeypatch.setattr(spans, "record", _record)
    least = registry.load_metric("i3d.pool_roofline.batch").least_time_s(8, 250, 224)
    want = {"i3d.pool_ms.batch": 6.5,
            "i3d.pool_roofline.batch": 100.0 * least / 0.0065}[name]
    assert reader.read(_run()) == pytest.approx(want)


def test_the_cpu_trace_lists_the_pool_readers_and_reads_neither():
    """On the tiny CPU run the pool readers are among the cell's traced
    metrics and stay silent (the CPU's spans have no CUDA events)."""
    r = _small.execute(CELL, trace=True)
    assert r["correct"], r["checks"]
    spec = registry.load_spec()
    names = set(registry.metric_names(spec, registry.find_cell(spec, CELL), trace=True))
    assert set(READERS) <= names
    assert not set(READERS) & set(r["metrics"])
