"""The Video Swin extraction cell: its FLOP model against a hand count at
the published widths, its reference against the port's, its four
per-layer readers, its loop at a tiny size on the CPU, and faults planted
in the program there, which its check must catch.

The loop's tiny CPU sizes and its control are registered here, on import,
as ``test_bench_timesformer.py`` registers TimeSformer's: every test
parametrised over the cells of ``BENCHMARK.json`` then runs this cell too,
wherever this module is collected with them."""

import json

import numpy as np
import pytest
import torch

from benchmark import control, flops_videoswin, registry, run, spans
from benchmark.loops import extract_videoswin
from benchmark.reference import videoswin as ref_net
from benchmark.tests import _small

CELL = "extract_videoswin_textured"
READERS = ("videoswin.attn_ms.batch", "videoswin.mlp_ms.batch",
           "videoswin.sdpa_roofline.batch", "videoswin.encoder_roofline.batch")

_small.LOOPS.setdefault("extract_videoswin", (extract_videoswin.SMALL_CONFIG,
                                              extract_videoswin.SMALL_TRAFFIC))
_control_readings = control.control_readings


def _with_videoswin(loop_name: str, cell, limits: dict) -> dict:
    if loop_name == "extract_videoswin":
        return extract_videoswin.control_readings(cell)
    return _control_readings(loop_name, cell, limits)


control.control_readings = _with_videoswin


def _config() -> dict:
    spec = registry.load_spec()
    return registry.load_config(spec, registry.find_cell(spec, CELL)["config"])


def test_flops_are_the_published_widths_by_hand():
    """A view's 562.7 GFLOP (the paper's 282 GMAC), counted stage by stage
    from the widths; 96 views a batch; the least times; the parameters."""
    c = _config()
    one = dict(c, batch_clips=1, num_clips=1, num_crops=1)
    by_hand = 2 * 50176 * 96 * 128                               # the patch projection
    for tokens, ch, heads, depth in ((16 * 56 * 56, 128, 4, 2), (16 * 28 * 28, 256, 8, 2),
                                     (16 * 14 * 14, 512, 16, 18), (16 * 7 * 7, 1024, 32, 2)):
        windows = tokens // 392
        by_hand += depth * (2 * tokens * ch * (3 * ch + ch + 4 * ch + 4 * ch)
                            + 4 * windows * heads * 392 ** 2 * 32)
    for tokens, ch in ((16 * 28 * 28, 128), (16 * 14 * 14, 256), (16 * 7 * 7, 512)):
        by_hand += 2 * tokens * 4 * ch * 2 * ch                  # the merges' reductions
    assert flops_videoswin.batch_flops(one) == by_hand
    assert by_hand / 1e9 == pytest.approx(562.7, abs=0.05)
    assert flops_videoswin.views(c) == 96
    assert flops_videoswin.batch_flops(c) == pytest.approx(96 * by_hand)
    assert flops_videoswin.batch_flops(c) / 1e12 == pytest.approx(54.0, abs=0.05)
    assert len(flops_videoswin.attention_cores(c)) == 24
    # q, k, v and the output: 38.2 GB a batch, bytes-bound (196 FLOP a byte)
    cores = flops_videoswin.attention_rows(c)
    assert sum(r[2] for r in cores) / 1e9 == pytest.approx(38.23, abs=0.01)
    assert all(r[1] / r[2] == pytest.approx(196.0) for r in cores)
    assert flops_videoswin.sdpa_least_time_s(c) == pytest.approx(11.41e-3, rel=1e-3)
    assert flops_videoswin.batch_least_time_s(c) == pytest.approx(69.66e-3, rel=1e-3)
    # the reference's parameters are the program's, less the head
    assert sum(int(np.prod(s)) for _l, _k, s in ref_net.layer_shapes(c)) == \
        c["params_without_head"] == 87_638_984


def test_the_benchmark_reference_is_the_port_reference():
    """The frozen copy in ``benchmark/reference`` against
    ``videoquery_torch/testing/videoswin_reference.py`` on the same weights
    and frames: the views and the signatures."""
    from videoquery_torch.testing import videoswin_reference

    torch.set_num_threads(2)
    small = dict(_config(), **extract_videoswin.SMALL_CONFIG)
    weights = ref_net.make_weights(torch.Generator().manual_seed(5), small, "cpu")
    params = {layer: {k: v.numpy() for k, v in leaf.items()} for layer, leaf in weights.items()}
    window = tuple(small["window_size"])
    x = torch.randn(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(ref_net.embed(weights, x, window),
                               videoswin_reference.embed(params, x, window), rtol=0, atol=0)
    frames = torch.randint(0, 256, (16, 40, 60, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(7))
    protocol = dict(clip_len=4, frame_interval=2, num_clips=2, short_side=32, crop=32)
    torch.testing.assert_close(ref_net.views(frames, small),
                               videoswin_reference.views(frames, **protocol), rtol=0, atol=0)


def _record():
    from videoquery_torch.core.profiling import SpanRecord, TraceRecord

    rec = TraceRecord()
    spans_ = [("videoswin.embed", 2.0)] * 2 + [("videoswin.attn", 3.0)] * 48 + \
        [("videoswin.mlp", 5.0)] * 48 + [("videoswin.merge", 1.0)] * 6 + \
        [("videoswin.sdpa", 0.5)] * 48
    rec.spans = [SpanRecord(name, i, None, 0, 1_000_000, device_ms=ms)
                 for i, (name, ms) in enumerate(spans_)]
    rec.counters = {"videoswin.sdpa_calls": 48, "videoswin.shifted_calls": 24,
                    "videoswin.views": 192}
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
    backbone_ms = (2 * 2.0 + 48 * 3.0 + 48 * 5.0 + 6 * 1.0) / 2
    want = {"videoswin.attn_ms.batch": 72.0, "videoswin.mlp_ms.batch": 120.0,
            "videoswin.sdpa_roofline.batch":
                100.0 * flops_videoswin.sdpa_least_time_s(c) / 0.012,
            "videoswin.encoder_roofline.batch":
                100.0 * flops_videoswin.batch_least_time_s(c) / (backbone_ms / 1e3)}[name]
    assert reader.read(_run()) == pytest.approx(want)


def test_the_cell_reports_what_the_contract_asks():
    spec = registry.load_spec()
    entry = registry.find_cell(spec, CELL)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert registry.metric_names(spec, entry, trace=False) == ["extract_clips_per_s", "setup_s"]
    assert set(registry.metric_names(spec, entry, trace=True)) == set(READERS) | {
        "extract.mfu", "device_idle.extract", "extract.upload_ms.batch"}
    config = _config()
    assert config["reduced"] == [] and config["embed_dim"] == 128
    assert config["depths"] == [2, 2, 18, 2] and config["num_heads"] == [4, 8, 16, 32]
    assert config["window_size"] == [8, 7, 7] and config["feature_dim"] == 1024
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
    """The program's own spans and counters in a CPU trace of the cell,
    read by the readers with their stream ms stood in by their host ms."""
    import videoquery_torch.core.profiling as profiling

    r = _small.execute(CELL, trace=True)
    rec = profiling.trace_record()
    totals = rec.totals()
    batches = rec.counters["videoswin.sdpa_calls"] // 8          # 4 stages of 2 blocks
    assert batches >= 1 and totals["videoswin.sdpa"]["calls"] == 8 * batches
    assert rec.counters["videoswin.views"] == 6 * batches        # 2 clips x 3 crops
    # 2 x 8 x 8 and 2 x 4 x 4 tokens shift in H and W; 2 x 2 x 2 and 2 x 1 x 1
    # fit one (2, 3, 3) window and do not shift
    assert rec.counters["videoswin.shifted_calls"] == 2 * batches
    assert totals["videoswin.embed"]["calls"] == batches
    assert totals["videoswin.merge"]["calls"] == 3 * batches
    for name in ("videoswin.attn", "videoswin.mlp"):
        assert totals[name]["calls"] == 8 * batches
    for s in rec.spans:
        s.device_ms = s.host_ms
    monkeypatch.setattr(spans, "record", lambda: rec)
    small = dict(_config(), **extract_videoswin.SMALL_CONFIG)
    work = run.Run(None, {"batches": batches, "batch_flops": 1.0}, small, {})
    for name in READERS:
        assert registry.load_metric(name).read(work) > 0, name
    assert r["correct"]


def _incorrect():
    r = _small.execute(CELL)
    assert not r["correct"], r["checks"]
    return r["checks"]


def test_the_shift_mask_left_out(monkeypatch):
    """Every shifted window attends across its regions."""
    import videoquery_torch.nn.video_swin as vs

    real = vs.region_mask
    monkeypatch.setattr(vs, "region_mask", lambda *a: np.zeros_like(real(*a)))
    checks = _incorrect()
    assert checks["rgb_rel_err"]["value"] > checks["rgb_rel_err"]["limit"]


def test_one_crop_for_all_three(monkeypatch):
    """The three views of a clip all read the middle crop."""
    import videoquery_torch.pipeline.preprocess as pre

    monkeypatch.setattr(pre, "THREE_CROP", ("mid", "mid", "mid"))
    checks = _incorrect()
    assert checks["rgb_rel_err"]["value"] > checks["rgb_rel_err"]["limit"]


def test_the_clips_sampled_from_the_first_half(monkeypatch):
    """The payload's views sample the segment's first half only."""
    import videoquery_torch.pipeline.extract as extract
    import videoquery_torch.pipeline.payload as payload

    for mod in (payload, extract):
        real = mod.view_frames
        monkeypatch.setattr(mod, "view_frames",
                            lambda n, *a, real=real: real(max(1, n // 2), *a))
    checks = _incorrect()
    assert checks["rgb_rel_err"]["value"] > checks["rgb_rel_err"]["limit"]
