"""The TimeSformer extraction cell: its FLOP model against a hand count at
the published widths, its reference against the port's, its five
per-layer readers, its loop at a tiny size on the CPU, and faults planted
in the program there, which its check must catch.

The loop's tiny CPU sizes and its control are registered here, on import,
as ``conftest.py`` registers the I3D loop's: every test parametrised over
the cells of ``BENCHMARK.json`` then runs this cell too, wherever this
module is collected with them."""

import json

import numpy as np
import pytest
import torch

from benchmark import control, flops_timesformer, registry, run, spans
from benchmark.loops import extract_timesformer
from benchmark.reference import timesformer as ref_net
from benchmark.tests import _small

CELL = "extract_timesformer_textured"
READERS = ("timesformer.time_attn_ms.batch", "timesformer.space_attn_ms.batch",
           "timesformer.mlp_ms.batch", "timesformer.sdpa_roofline.batch",
           "timesformer.encoder_roofline.batch")

_small.LOOPS.setdefault("extract_timesformer", (extract_timesformer.SMALL_CONFIG,
                                                extract_timesformer.SMALL_TRAFFIC))
_control_readings = control.control_readings


def _with_timesformer(loop_name: str, cell, limits: dict) -> dict:
    if loop_name == "extract_timesformer":
        return extract_timesformer.control_readings(cell)
    return _control_readings(loop_name, cell, limits)


control.control_readings = _with_timesformer


def _config() -> dict:
    spec = registry.load_spec()
    return registry.load_config(spec, registry.find_cell(spec, CELL)["config"])


def test_flops_are_the_published_widths_by_hand():
    c = _config()
    one = dict(c, batch_clips=1)
    n, t, d, m = 196, 96, 768, 3072
    patches, frame_rows, tokens = n * t, t * (1 + n), 1 + n * t
    by_hand = 2 * patches * 768 * d + 12 * (
        2 * patches * d * (3 * d + d + d) + 2 * frame_rows * d * (3 * d + d)
        + 2 * tokens * d * m * 2
        + 4 * (n * 12) * t * t * 64 + 4 * (t * 12) * (1 + n) ** 2 * 64)
    assert flops_timesformer.batch_flops(one) == by_hand
    assert by_hand / 1e12 == pytest.approx(4.76, abs=0.005)
    assert len(flops_timesformer.attention_cores(one)) == 24
    assert sum(r[1] for r in flops_timesformer.attention_rows(c)) / 1e12 == \
        pytest.approx(1.631, abs=0.001)
    assert flops_timesformer.batch_flops(c) == pytest.approx(8 * by_hand)
    # each attention core moves ~0.93 GB of q, k, v and output a batch: memory-bound
    core = flops_timesformer.attention_rows(c)[0]
    assert core[2] == pytest.approx(0.925e9, rel=1e-3) and core[1] / core[2] < 295
    assert flops_timesformer.sdpa_least_time_s(c) == pytest.approx(6.64e-3, rel=1e-2)
    assert flops_timesformer.batch_least_time_s(c) >= flops_timesformer.batch_flops(c) / 989e12
    # the reference's parameters are the program's, less the head
    want = c["params_without_head"]
    assert sum(int(np.prod(s)) for _l, _k, s in ref_net.layer_shapes(c)) == want


def test_the_benchmark_reference_is_the_port_reference():
    """The frozen copy in ``benchmark/reference`` against
    ``videoquery_torch/testing/timesformer_reference.py`` on the same
    weights."""
    from videoquery_torch.testing import timesformer_reference

    torch.set_num_threads(2)
    small = dict(_config(), **dict(extract_timesformer.SMALL_CONFIG, depth=2))
    weights = ref_net.make_weights(torch.Generator().manual_seed(5), small, "cpu")
    params = {layer: {k: v.numpy() for k, v in leaf.items()} for layer, leaf in weights.items()}
    x = torch.randn(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(ref_net.embed(weights, x, 4),
                               timesformer_reference.embed(params, x, 4), rtol=0, atol=0)
    frames = torch.randint(0, 256, (2, 16, 64, 88, 3), dtype=torch.uint8)
    cfg = extract_timesformer.extraction_config(small)
    got = extract_timesformer.reference_inputs(frames, cfg)
    want = timesformer_reference.preprocess(
        frames[:, timesformer_reference.sample_indices(16, 4)], 32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _record():
    from videoquery_torch.core.profiling import SpanRecord, TraceRecord

    rec = TraceRecord()
    spans_ = [("timesformer.embed", 2.0)] * 2 + [("timesformer.time_attn", 3.0)] * 24 + \
        [("timesformer.space_attn", 4.0)] * 24 + [("timesformer.mlp", 5.0)] * 24 + \
        [("timesformer.sdpa", 0.5)] * 48
    rec.spans = [SpanRecord(name, i, None, 0, 1_000_000, device_ms=ms)
                 for i, (name, ms) in enumerate(spans_)]
    rec.counters = {"timesformer.sdpa_calls": 48}
    return rec


def _run():
    return run.Run(None, {"batches": 2, "batch_flops": 1.0}, _config(), {})


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_its_spans_and_is_silent_without_them(name, monkeypatch):
    spec = registry.load_spec()
    entry = registry.metric_entry(spec, name)
    assert entry["workloads"] == [CELL] and entry["moves"] == "extract_clips_per_s"
    reader = registry.load_metric(name)
    # a program without the spans (the parent): silent, no error
    monkeypatch.setattr(spans, "record", lambda: None)
    assert reader.read(_run()) is None
    from videoquery_torch.core.profiling import TraceRecord

    monkeypatch.setattr(spans, "record", lambda: TraceRecord())
    assert reader.read(_run()) is None
    monkeypatch.setattr(spans, "record", _record)
    c = _config()
    encoder_ms = (2 * 2.0 + 24 * (3.0 + 4.0 + 5.0)) / 2
    want = {"timesformer.time_attn_ms.batch": 36.0, "timesformer.space_attn_ms.batch": 48.0,
            "timesformer.mlp_ms.batch": 60.0,
            "timesformer.sdpa_roofline.batch":
                100.0 * flops_timesformer.sdpa_least_time_s(c) / 0.012,
            "timesformer.encoder_roofline.batch":
                100.0 * flops_timesformer.batch_least_time_s(c) / (encoder_ms / 1e3)}[name]
    assert reader.read(_run()) == pytest.approx(want)


def test_the_cell_reports_what_the_contract_asks():
    spec = registry.load_spec()
    entry = registry.find_cell(spec, CELL)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert registry.metric_names(spec, entry, trace=False) == ["extract_clips_per_s", "setup_s"]
    assert set(registry.metric_names(spec, entry, trace=True)) == set(READERS) | {
        "extract.mfu", "device_idle.extract", "extract.upload_ms.batch"}
    config = _config()
    assert config["reduced"] == [] and config["embed_dim"] == 768
    json.dumps(config)


def test_the_cpu_run_is_correct_and_reads_the_host_metrics():
    """The cell at its tiny CPU size: correct, its end-to-end metrics, and
    in a traced run the host readings (the device readers are silent: no
    CUDA events on the CPU)."""
    r = _small.execute(CELL)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"extract_clips_per_s", "setup_s"}
    r = _small.execute(CELL, trace=True)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"extract.mfu", "device_idle.extract"}


def test_the_readers_on_a_cpu_trace_of_the_program(monkeypatch):
    """The program's own spans and counter in a CPU trace of the cell, read
    by the readers with their stream ms stood in by their host ms."""
    import videoquery_torch.core.profiling as profiling

    r = _small.execute(CELL, trace=True)
    rec = profiling.trace_record()
    totals = rec.totals()
    batches = rec.counters["timesformer.sdpa_calls"] // 2     # 1 block a forward here
    assert batches >= 1 and totals["timesformer.sdpa"]["calls"] == 2 * batches
    for name in ("timesformer.embed", "timesformer.time_attn", "timesformer.space_attn",
                 "timesformer.mlp"):
        assert totals[name]["calls"] == batches
    for s in rec.spans:
        s.device_ms = s.host_ms
    monkeypatch.setattr(spans, "record", lambda: rec)
    small = dict(_config(), **extract_timesformer.SMALL_CONFIG)
    work = run.Run(None, {"batches": batches, "batch_flops": 1.0}, small, {})
    for name in READERS:
        assert registry.load_metric(name).read(work) > 0, name
    assert r["correct"]


def _incorrect():
    r = _small.execute(CELL)
    assert not r["correct"], r["checks"]
    return r["checks"]


def test_the_time_attention_left_out(monkeypatch):
    """Each block's time step does nothing."""
    from videoquery_torch.nn.timesformer import TimeSformer

    monkeypatch.setattr(TimeSformer, "_time_attn", lambda self, w, i, x, t: None)
    checks = _incorrect()
    assert checks["rgb_rel_err"]["value"] > checks["rgb_rel_err"]["limit"]


def test_the_cls_token_misses_its_space_update(monkeypatch):
    """The space step leaves the CLS token as it was: no frame mean of its
    rows is added."""
    from videoquery_torch.nn.timesformer import TimeSformer

    real = TimeSformer._space_attn

    def without_cls(self, w, i, x, t):
        cls = x[:, 0].clone()
        real(self, w, i, x, t)
        x[:, 0] = cls
    monkeypatch.setattr(TimeSformer, "_space_attn", without_cls)
    checks = _incorrect()
    assert checks["rgb_rel_err"]["value"] > checks["rgb_rel_err"]["limit"]


def test_the_frames_sampled_from_the_first_half(monkeypatch):
    """The payload samples the segment's first half only."""
    import videoquery_torch.pipeline.payload as payload

    real = payload.linspace_frames
    monkeypatch.setattr(payload, "linspace_frames",
                        lambda n, num: real(max(1, n // 2), num))
    checks = _incorrect()
    assert checks["rgb_rel_err"]["value"] > checks["rgb_rel_err"]["limit"]
