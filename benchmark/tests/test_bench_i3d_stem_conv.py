"""The I3D cell's stem conv readers (``i3d.stem_conv_ms.batch``,
``i3d.stem_conv_roofline.batch``): their entries, their reading of the
program's ``i3d.stem_conv`` spans, their silence on a program without them,
and the unpadded ``Conv3d_1a_7x7`` rows of ``flops_i3d`` the roofline
divides by."""

import pytest

from benchmark import flops_i3d, registry, spans, stats
from benchmark.tests import _small
from benchmark.tests.test_bench_i3d_pool import _run

CELL = "extract_i3d_textured"
READERS = ("i3d.stem_conv_ms.batch", "i3d.stem_conv_roofline.batch")


def _record(with_stem_conv: bool = True):
    from videoquery_torch.core.profiling import SpanRecord, TraceRecord

    rec = TraceRecord()
    spans_ = [("i3d.stem", 10.0)] * 4 + [("i3d.mixed", 20.0)] * 4
    if with_stem_conv:
        spans_ += [("i3d.stem_conv", 3.0)] * 4          # 1 a forward, 2 streams, 2 batches
    rec.spans = [SpanRecord(name, i, None, 0, 1_000_000, device_ms=ms)
                 for i, (name, ms) in enumerate(spans_)]
    rec.counters = {"i3d.stem_conv_launches": 4 if with_stem_conv else 0}
    return rec


def test_the_stem_convs_least_time():
    """The two Conv3d_1a_7x7 rows at 8 x 250 (249) x 224x224: 1.652 and
    1.101 TFLOP over the 343 taps, unpadded, 2.784 ms a batch at 989
    TFLOP/s; the operations bound them."""
    reader = registry.load_metric("i3d.stem_conv_roofline.batch")
    rows = {}
    for frames, channels in ((250, 3), (249, 2)):
        (row,) = [r for r in flops_i3d.model(8, frames, 224, channels) if r[0] == reader.STEM]
        assert row[1] == 2 * 8 * 125 * 112 * 112 * 343 * channels * 64
        assert row[1] / stats.PEAK_BF16_FLOPS > (row[2] + row[3] + row[4]) / (
            stats.PEAK_HBM_BYTES_PER_S)
        rows[channels] = row[1]
    assert rows[3] == pytest.approx(1.652e12, rel=1e-3)
    assert rows[2] == pytest.approx(1.101e12, rel=1e-3)
    least = reader.least_time_s(8, 250, 224)
    assert least == pytest.approx((rows[3] + rows[2]) / stats.PEAK_BF16_FLOPS)
    assert least == pytest.approx(2.7842e-3, rel=1e-4)
    # the stem conv is a part of the net's least time
    assert least < flops_i3d.batch_least_time_s(8, 250, 224)


@pytest.mark.parametrize("name", READERS)
def test_a_stem_conv_reader_reads_its_spans_and_is_silent_without_them(name, monkeypatch):
    spec = registry.load_spec()
    entry = registry.metric_entry(spec, name)
    assert entry["workloads"] == [CELL] and entry["moves"] == "extract_clips_per_s"
    assert entry["layer"] == "kernels" and entry["source"] == "program_span"
    reader = registry.load_metric(name)
    from videoquery_torch.core.profiling import TraceRecord

    # no record, an empty one, and the parent's (stem and Mixed spans, no stem conv)
    for rec in (None, TraceRecord(), _record(with_stem_conv=False)):
        monkeypatch.setattr(spans, "record", lambda rec=rec: rec)
        assert reader.read(_run()) is None
    monkeypatch.setattr(spans, "record", _record)
    least = registry.load_metric("i3d.stem_conv_roofline.batch").least_time_s(8, 250, 224)
    want = {"i3d.stem_conv_ms.batch": 6.0,
            "i3d.stem_conv_roofline.batch": 100.0 * least / 0.006}[name]
    assert reader.read(_run()) == pytest.approx(want)


def test_the_cpu_trace_lists_the_stem_conv_readers_and_reads_neither():
    """On the tiny CPU run the stem conv readers are among the cell's traced
    metrics and stay silent (the CPU's spans have no CUDA events)."""
    r = _small.execute(CELL, trace=True)
    assert r["correct"], r["checks"]
    spec = registry.load_spec()
    names = set(registry.metric_names(spec, registry.find_cell(spec, CELL), trace=True))
    assert set(READERS) <= names
    assert not set(READERS) & set(r["metrics"])
