"""The I3D extraction cell: its FLOP model, its reference against the
port's, its four per-layer readers, and faults planted in the program at a
tiny size on the CPU, which its check must catch."""

import pytest
import torch

from benchmark import flops_i3d, registry, run, spans
from benchmark.reference import i3d as ref_net
from benchmark.tests import _small

CELL = "extract_i3d_textured"
READERS = ("i3d.stem_ms.batch", "i3d.mixed_ms.batch", "i3d.conv_roofline.batch",
           "extract.flow_us.pair")


def test_flops_are_the_published_layer_list():
    gflop = {n: sum(r[1] for r in flops_i3d.model(1, n, 224, c)) / 1e9
             for n, c in ((64, 3), (250, 3), (249, 2))}
    # ~108 G multiply-adds at 64 frames (the paper); a 250-frame segment and its 249 pairs
    assert gflop[64] == pytest.approx(222.3, abs=0.1)
    assert gflop[250] == pytest.approx(869.9, abs=0.1)
    assert gflop[249] == pytest.approx(801.0, abs=0.1)
    assert flops_i3d.batch_flops(8, 250) == pytest.approx(8e9 * (gflop[250] + gflop[249]))
    weights = {c: sum(k[0] * k[1] * k[2] * ci * co for _n, k, ci, co in ref_net.conv_layers(c))
               for c in (3, 2)}
    assert weights == {3: 12_272_704, 2: 12_250_752}
    # the least time is at least the operations' bound
    assert flops_i3d.batch_least_time_s(8, 250) >= flops_i3d.batch_flops(8, 250) / 989e12


def test_the_benchmark_reference_is_the_port_reference():
    """The frozen copy in ``benchmark/reference`` against
    ``videoquery_torch/testing/i3d_reference.py`` on the same weights."""
    from videoquery_torch.testing import i3d_reference

    torch.set_num_threads(2)
    g = torch.Generator().manual_seed(5)
    weights = ref_net.make_weights(g, 2, "cpu")
    params = {name: {"w": w.permute(2, 3, 4, 1, 0).numpy(), "b": b.numpy()}
              for name, (w, b) in weights.items()}
    params[i3d_reference.LOGITS] = {"w": torch.zeros(1024, 4).numpy(),
                                    "b": torch.zeros(4).numpy()}
    x = torch.rand(1, 9, 40, 36, 2, generator=g) * 2 - 1
    torch.testing.assert_close(ref_net.embed(weights, x), i3d_reference.embed(params, x),
                               rtol=0, atol=0)


def _record():
    from videoquery_torch.core.profiling import SpanRecord, TraceRecord

    rec = TraceRecord()
    spans_ = [("extract.flow", 30.0), ("extract.flow", 34.0)] + \
        [("i3d.stem", 10.0)] * 4 + [("i3d.mixed", 20.0)] * 4
    rec.spans = [SpanRecord(name, i, None, 0, 1_000_000, device_ms=ms)
                 for i, (name, ms) in enumerate(spans_)]
    rec.counters = {"extract.flow_pairs": 3984}
    return rec


def _run():
    spec = registry.load_spec()
    config = registry.load_config(spec, registry.find_cell(spec, CELL)["config"])
    return run.Run(None, {"batches": 2, "batch_flops": 1.0}, config, {})


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_its_spans_and_is_silent_without_them(name, monkeypatch):
    spec = registry.load_spec()
    entry = registry.metric_entry(spec, name)
    assert CELL in entry["workloads"] and entry["moves"] == "extract_clips_per_s"
    reader = registry.load_metric(name)
    # a program without the spans and counter (the parent): silent, no error
    monkeypatch.setattr(spans, "record", lambda: None)
    assert reader.read(_run()) is None
    from videoquery_torch.core.profiling import TraceRecord

    monkeypatch.setattr(spans, "record", lambda: TraceRecord())
    assert reader.read(_run()) is None
    monkeypatch.setattr(spans, "record", _record)
    least = flops_i3d.batch_least_time_s(8, 250, 224)
    want = {"i3d.stem_ms.batch": 20.0, "i3d.mixed_ms.batch": 40.0,
            "i3d.conv_roofline.batch": 100.0 * least / 0.060,
            "extract.flow_us.pair": 1e3 * 64.0 / 3984}[name]
    assert reader.read(_run()) == pytest.approx(want)


def test_the_cpu_trace_reads_the_host_metrics_and_no_device_metric():
    """The extraction cell's readers on the I3D cell's tiny CPU run: the
    host ones read, the device ones (no CUDA events on the CPU) stay
    silent."""
    r = _small.execute(CELL, trace=True)
    assert r["correct"], r["checks"]
    spec = registry.load_spec()
    names = set(registry.metric_names(spec, registry.find_cell(spec, CELL), trace=True))
    assert set(READERS) | {"extract.upload_ms.batch", "extract.flow_ms.batch",
                           "extract.nets_ms.batch", "extract.host_wait_ms.batch",
                           "extract.mfu", "device_idle.extract"} == names
    assert set(r["metrics"]) == {"extract.host_wait_ms.batch", "extract.mfu",
                                 "device_idle.extract"}
    assert r["metrics"]["extract.host_wait_ms.batch"]["value"] > 0


def _incorrect():
    r = _small.execute(CELL)
    assert not r["correct"], r["checks"]
    return r["checks"]


def test_flow_returns_its_state_unchanged(monkeypatch):
    """Each TV-L1 level returns the flow it was given."""
    import videoquery_torch.kernels.tvl1_flow as flow

    monkeypatch.setattr(flow, "tvl1_level", lambda i0, i1, u, v, p, d: (u, v))
    checks = _incorrect()
    assert checks["flow_rel_err"]["value"] > checks["flow_rel_err"]["limit"]


def test_half_the_frames_left_out(monkeypatch):
    """The net sees the first half of each volume."""
    import videoquery_torch.pipeline.extract as ex

    real = ex._stream_embed

    def half(stream, x, mesh=None):
        return real(stream, x[:, : max(1, x.shape[1] // 2)].contiguous(), mesh)
    monkeypatch.setattr(ex, "_stream_embed", half)
    checks = _incorrect()
    assert checks["rgb_rel_err"]["value"] > checks["rgb_rel_err"]["limit"]


def test_flow_left_in_flow_grid_pixels(monkeypatch):
    """The flow volume without its scale to native pixels."""
    import videoquery_torch.pipeline.extract as ex

    real = ex._flow_field
    monkeypatch.setattr(ex, "_flow_field", lambda u, v, cfg, scale: real(u, v, cfg, (1.0, 1.0)))
    checks = _incorrect()
    assert checks["flow_rel_err"]["value"] > checks["flow_rel_err"]["limit"]
