"""The port's spans and counters (videoquery_torch.core.profiling).

- Untraced, ``span`` and ``count`` record nothing and make no CUDA event,
  no ``record_function`` range and no synchronise.
- Traced, a span records its name, parent (the chain of parents ends at the
  request's root span) and its self time; counters add up; a CUDA device's
  events are read only in ``trace_record()``.
- K1's span opens after the targets' cast and holds the launch alone (on
  the card, its device ms against K1's kernel time:
  ``tests/test_torch_cuda_kernels.py``).
- ``device_trace`` writes the spans as ``vq.*`` ranges nested inside their
  callers' ranges in the Chrome trace, and a record holds one window.
- A tiny resident round on the CPU records the engine's, the optimizer's
  and selection's spans, and the band's size; a tiny extraction batch the
  extraction's spans in order, and the rescue's pairs.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from videoquery_torch.core import profiling
from videoquery_torch.core.config import ExtractionConfig, HyperParams
from videoquery_torch.core.profiling import count, device_trace, span, trace_record
from videoquery_torch.kernels import query as k1
from videoquery_torch.nn.tsn import TwoStreamTSN
from videoquery_torch.pipeline import extract as te
from videoquery_torch.pipeline.payload import build_payload, plan_groups
from videoquery_torch.search.engine import SearchEngine, optimize_many, round_scores_many
from videoquery_torch.search.selection import select_clips_to_review
from videoquery_torch.testing import multihost_worker as mw
from videoquery_torch.testing.sharded_serving import cone_world

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

CUDA = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Each test starts with no record and untraced."""
    monkeypatch.setattr(profiling, "_state", profiling._State())


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def names(rec):
    return [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)]


def root_of(rec, s):
    """The id of the root span of ``s``'s request."""
    by = {x.id: x for x in rec.spans}
    while s.parent is not None:
        s = by[s.parent]
    return s.id


def test_untraced_records_nothing_and_makes_no_event_range_or_synchronise(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("made while untraced")

    for mod, attr in ((torch.cuda, "Event"), (torch.cuda, "synchronize"),
                      (torch.cuda, "current_stream"), (torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function")):
        monkeypatch.setattr(mod, attr, refuse)
    first = span("a", CUDA)
    with first:
        with span("b", CUDA):
            count("c", 5)
    assert span("d") is first            # one shared no-op context
    assert trace_record() is None


class FakeEvent:
    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded, self.synced = None, False
        FakeEvent.made.append(self)

    def record(self, stream):
        self.recorded = (stream, time.perf_counter_ns())

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert end.synced
        return (end.recorded[1] - self.recorded[1]) / 1e6


def test_traced_records_names_parents_requests_self_time_and_counters(monkeypatch):
    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: ("stream", device))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronised"))
    with traced():
        with span("root", CUDA):
            time.sleep(0.01)
            with span("root.a"):
                time.sleep(0.02)
                count("n", 2)
            with span("root.b"):
                time.sleep(0.01)
            count("n")
        with span("other"):
            count("m", 7)
        # the device's events are recorded on its stream, never waited on
        assert len(FakeEvent.made) == 2
        assert all(e.recorded[0] == ("stream", CUDA) and not e.synced for e in FakeEvent.made)
    rec = trace_record()
    by = {s.name: s for s in rec.spans}
    assert names(rec) == ["root", "root.a", "root.b", "other"]
    assert by["root.a"].parent == by["root.b"].parent == by["root"].id
    assert by["root"].parent is None and by["other"].parent is None
    assert root_of(rec, by["root.a"]) == root_of(rec, by["root.b"]) == by["root"].id
    assert root_of(rec, by["other"]) == by["other"].id
    root = by["root"]
    assert root.self_ms == pytest.approx(root.host_ms - by["root.a"].host_ms
                                         - by["root.b"].host_ms)
    assert root.self_ms >= 10 and by["root.a"].self_ms >= 20
    # device ms only where a CUDA device was named, read after the window
    assert FakeEvent.made[1].synced and 40 <= root.device_ms
    assert by["root.a"].device_ms is None
    assert rec.counters == {"n": 3, "m": 7}
    totals = rec.totals()
    assert totals["root"]["calls"] == 1 and totals["root.a"]["device_ms"] is None
    assert totals["root"]["device_ms"] == root.device_ms


def test_a_record_holds_only_its_own_window():
    with traced():
        with span("first"):
            count("k")
    with span("untraced"):
        count("k")
    with traced():
        with span("second"):
            count("k", 4)
    rec = trace_record()
    assert names(rec) == ["second"] and rec.counters == {"k": 4}
    with span("after"):                  # untraced work leaves the record alone
        pass
    assert trace_record() is rec and names(rec) == ["second"]


def test_device_trace_nests_vq_ranges_inside_their_callers(tmp_path):
    with traced():                       # a window before, with nothing untraced between
        with span("before"):
            pass
    with device_trace(str(tmp_path)):
        with record_function("caller"):
            with span("outer"):
                torch.ones(256).cumsum(0)
                with span("inner"):
                    torch.ones(256).cumsum(0)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    ranges = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    for outside, inside in (("caller", "vq.outer"), ("vq.outer", "vq.inner")):
        assert ranges[outside][0] <= ranges[inside][0] <= ranges[inside][1] \
            <= ranges[outside][1], (outside, inside)
    spans = json.load(open(tmp_path / "spans.json"))
    assert [s["name"] for s in spans["spans"]] == ["inner", "outer"]   # as they closed
    assert set(spans["totals"]) == {"outer", "inner"}


def test_k1s_span_holds_its_launches_alone(monkeypatch):
    """The bf16 index's split of f32 targets is queued before the span, and
    inside it (on the card: between its two events) no tensor op runs, only
    the launches, each chunk's operands addressed a chunk of rows on."""
    marks, launches = {}, []
    split = k1.split_targets_bf16

    def timed_split(t):
        out = split(t)
        marks["split"] = time.perf_counter_ns()
        return out

    def launch(entry, name, device, *args):
        launches.append((time.perf_counter_ns(), args))

    monkeypatch.setattr(k1, "split_targets_bf16", timed_split)
    monkeypatch.setattr(k1, "_on_cuda", lambda feats: True)
    monkeypatch.setattr(k1._launch, "launch", launch)
    monkeypatch.setattr(k1, "_max_q", 2)              # Q = 4: two chunks
    feats = torch.randn(2, 3, 16, 8).to(torch.bfloat16)
    with traced() as prof:
        k1.query_k1(feats, torch.ones(2, 3, 16, dtype=torch.bool), torch.randn(4, 2, 3, 8),
                    torch.ones(4, 2, 3, dtype=torch.bool), target_dtype=torch.float32)
    [s] = trace_record().spans
    assert s.name == "kernels.k1"
    assert marks["split"] < s.start_ns < launches[0][0] < launches[1][0] < s.end_ns
    [rng] = [e.time_range for e in prof.events() if e.name == "vq.kernels.k1"]
    assert not [e.name for e in prof.events() if e.name.startswith("aten::")
                and rng.start < e.time_range.start < rng.end]
    # targets bf16 [Q, 3, 2, 3, 8], tmask [Q, 2, 3], no weights, avg and
    # counts [Q, 2, 16]: each address two rows on in the second chunk
    (_, a), (_, b) = launches
    assert [b[i] - a[i] for i in (3, 5, 6, 7, 8)] == [2 * 288, 2 * 6, 0, 2 * 128, 2 * 128]
    assert (a[9], b[9]) == (2, 2)


HP = HyperParams(streams=("rgb", "warped_optical_flow"))


@pytest.mark.parametrize("q", [1, 3])
def test_a_resident_round_records_the_engine_optimizer_and_selection(q):
    world = cone_world(400, 32, 3, device="cpu")
    engine = SearchEngine(world.index)
    ids = world.index.clip_ids
    order = np.argsort(world.thetas)
    reviewed = [order[j] for j in range(0, 200, 10)]
    labels = {int(ids[p]): float(world.thetas[p] < 0.5) for p in reviewed}
    user = {str(c): bool(v) for c, v in labels.items()}
    with traced():
        tables = engine.compute_similarities_multi(world.targets[:q], resident=True)
        if q > 1:
            fits = optimize_many(tables, [labels] * q, HP)
        else:
            fits = [tables[0].optimize(labels, HP)]
        hps = [f[0] for f in fits]
        rounds = [{"weights": h.weights, "threshold": h.threshold,
                   "near_miss": h.near_miss_default, "keep_ids": [], "user_match_ids": [],
                   "finalize": False} for h in hps]
        if q > 1:
            bands = round_scores_many(tables, rounds)
        else:
            r = rounds[0]
            bands = [tables[0].round_scores(r["weights"], r["threshold"], r["near_miss"])]
        for band, h in zip(bands, hps):
            select_clips_to_review(band, user, None, h.threshold, 20, h.near_miss_default)
    rec = trace_record()
    totals = rec.totals()
    want = {"engine.similarity": 1, "kernels.k1": 1, "optimizer": 1, "optimizer.fetch": 1,
            "optimizer.grid": 1, "engine.banded": 1, "engine.band_rows": 1,
            "engine.band_unpack": q, "selection": q}
    assert {n: t["calls"] for n, t in totals.items()} == want
    by = {s.id: s for s in rec.spans}
    for s in rec.spans:
        parent = by[s.parent].name if s.parent is not None else None
        assert parent == {"kernels.k1": "engine.similarity",
                          "optimizer.fetch": "optimizer", "optimizer.grid": "optimizer",
                          "engine.band_rows": "engine.banded",
                          "engine.band_unpack": "engine.banded"}.get(s.name), s.name
    assert totals["kernels.k1"]["device_ms"] is None             # the CPU: no events
    assert all(0 < len(b) < 400 for b in bands)
    assert rec.counters == {"engine.band_clips": sum(len(b) for b in bands),
                            "engine.band_slots": q * 32_768}


# 2 clips of 10 frames a batch at 64x80, 3 ticks (tests/test_torch_dispatch.py's)
CFG = ExtractionConfig(fps=5, clip_seconds=2, num_ticks=3, frame_resize=(80, 64),
                       crop_size=64, batch_clips=2, min_tail_seconds=1)
TVL1 = dataclasses.replace(mw.extract_world_tvl1(), rescue_trigger=0.3)


@pytest.fixture(scope="module")
def tsn():
    return TwoStreamTSN.random(0, (1,), "cpu")


def payload(kind: str):
    video = mw.extract_world_video(n_frames=20)
    if kind == "still":
        video = np.repeat(video[[0, 10]], 10, axis=0)
    [(group, nums)] = plan_groups(len(video), CFG)
    return build_payload(video, None, group, nums, CFG, CFG.flow_res_div)


@pytest.mark.parametrize("kind", ["moving", "still"])
def test_a_dispatched_batch_records_the_extraction_spans_in_order(tsn, kind):
    extractor = te.Extractor(tsn, CFG, tvl1=TVL1, device="cpu")
    with traced():
        extractor._dispatch_payload(payload(kind))
    rec = trace_record()
    assert names(rec) == ["extract.dispatch", "extract.upload", "extract.flow",
                          "extract.rgb_net", "extract.flow_net", "extract.rescue_wait"]
    by = {s.name: s for s in rec.spans}
    root = by["extract.dispatch"]
    for name, parent in (("extract.upload", root), ("extract.flow", root),
                         ("extract.rgb_net", root), ("extract.flow_net", root),
                         ("extract.rescue_wait", by["extract.flow_net"])):
        assert by[name].parent == parent.id
    # the moving batch fires the rescue: a quarter of its 2 x 9 pairs, rounded
    rescued = {"extract.rescue_pairs": 4} if kind == "moving" else {}
    assert rec.counters == dict(rescued, **{"extract.flow_pairs": 18})


def test_the_step_decided_at_once_records_the_flow_and_both_nets(tsn):
    plan = te.step_plan(10, CFG, "pallas", "cpu")
    frames = torch.from_numpy(mw.extract_world_video(n_frames=20).reshape(2, 10, 64, 80, 3))
    with traced():
        te.embed_step(tsn, *te.prepare_step(frames, plan, CFG, True, TVL1))
    rec = trace_record()
    # the input prep between the halves is in no span: it is neither net
    assert names(rec) == ["extract.flow", "extract.rescue_wait", "extract.rgb_net",
                          "extract.flow_net"]
    assert rec.counters == {"extract.rescue_pairs": 4, "extract.flow_pairs": 18}
