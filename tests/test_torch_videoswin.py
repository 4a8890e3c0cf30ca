"""Video Swin (``videoquery_torch/nn/video_swin.py``), its test views and
the rgb-only extraction path it runs on, against the plain reference
``videoquery_torch/testing/videoswin_reference.py`` on seeded random
weights, at small sizes on the CPU.

The small net: embed 32, depths [2, 2, 2, 2], heads [1, 2, 4, 8] (head
dim 32, as published), window (2, 3, 3). On 8 frames of 48x48 its stages
are 4 x 12 x 12, 4 x 6 x 6, 4 x 3 x 3 (the spatial window clamped to the
tokens, no spatial shift) and 4 x 2 x 2 (after the merge's odd-size pad;
the window clamped, and the bias index cut to [:N, :N]); on 6 frames of
48x64 the windows need the block's pad too (3 x 12 x 16 tokens).

- Float32: rtol 1e-5 / atol 1e-5 on signatures of unit scale (the mean of
  the final LayerNorm's output). The port and the reference do the same f32
  arithmetic in another order (a GEMM over the patches against the
  published Conv3d, SDPA's softmax against the explicit one, the gathers
  against the pad, roll and partition copies); the differences seen are
  ~1e-6. 1e-5 is ~80 float32 ulps at 1 and 400 times below one bf16
  rounding.
- bfloat16 against the float32 reference: mean |port - reference| / mean
  |reference| < 2%, the port's bound for bf16 networks
  (``tests/test_torch_nn.py``). Every linear, LayerNorm, residual add and
  the bias itself round to 8 bits of mantissa; measured ~0.8-0.9% here.
- Each of four planted faults (the shift mask dropped, the relative index
  transposed, the roll's sign flipped, PatchMerging's x1 and x2 swapped)
  moves the signature by 10% or more (13% to 34% measured), far past both
  bounds.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videoquery_torch.core import profiling
from videoquery_torch.core.config import FLOW, RGB, ExtractionConfig
from videoquery_torch.index.csvio import read_feature_tree
from videoquery_torch.index.records import FeatureRecord
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.nn import video_swin as vs
from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN
from videoquery_torch.pipeline import decode
from videoquery_torch.pipeline import extract as te
from videoquery_torch.pipeline import preprocess
from videoquery_torch.pipeline.payload import build_payload, plan_groups
from videoquery_torch.pipeline.temporal_sampling import multiview_frames, view_frames
from videoquery_torch.testing import videoswin_reference as ref

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-5
BF16_VS_F32 = 0.02

WINDOW = (2, 3, 3)
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8), window=WINDOW)
SHAPES = [(8, 48, 48), (6, 48, 64)]

# segments of 16 frames at 40x60, views of 2 clips x 4 frames (interval 2)
# x 3 crops of 32 on a short side of 32 (32 x 48)
CFG = ExtractionConfig(arch="videoswin", fps=4, clip_seconds=4, frame_resize=(60, 40),
                       crop_size=32, batch_clips=2, view_clip_len=4, view_frame_interval=2,
                       view_clips=2)
PROTOCOL = dict(clip_len=4, frame_interval=2, num_clips=2, short_side=32, crop=32)


def mean_rel(got, want) -> float:
    return float((got - want).abs().mean() / want.abs().mean())


def with_layer_norm_affine(params: dict, seed: int) -> dict:
    """params with every LayerNorm's weight and bias drawn (1 + N(0, 0.1^2),
    N(0, 0.1^2)), so the checks see their affine part too."""
    rng = np.random.default_rng(seed)
    out = {k: dict(v) for k, v in params.items()}
    for layer, leaf in out.items():
        if layer.split("/")[-1] in ("norm", "norm1", "norm2"):
            leaf["w"] = (1 + 0.1 * rng.standard_normal(leaf["w"].shape)).astype(np.float32)
            leaf["b"] = (0.1 * rng.standard_normal(leaf["b"].shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def params():
    return with_layer_norm_affine(vs.make_weights(5, **SMALL), 6)


def volume(shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def small_net(params):
    return vs.VideoSwin(params, window=WINDOW)


def test_published_widths():
    shapes = vs.layer_shapes()
    total = sum(int(np.prod(s)) for _l, _k, s in shapes)
    head = sum(int(np.prod(s)) for layer, _k, s in shapes if layer == vs.HEAD)
    assert (total, total - head) == (88_048_984, 87_638_984)
    assert vs.stage_dims() == [128, 256, 512, 1024]
    assert [c // h for c, h in zip(vs.stage_dims(), vs.HEADS)] == [32] * 4
    tables = {s for layer, k, s in shapes if k == vs.TABLE}
    assert tables == {(2535, 4), (2535, 8), (2535, 16), (2535, 32)}
    net = vs.VideoSwin(vs.make_weights(0, depths=(1, 1, 1, 1)))
    assert (net.patch, net.embed_dim, net.heads, net.window) == \
        ((2, 4, 4), 128, [4, 8, 16, 32], (8, 7, 7))


@pytest.mark.parametrize("shape", SHAPES)
def test_float32_against_the_reference(params, shape):
    x = volume((2,) + shape + (3,))
    got = small_net(params).embed(x)
    assert got.dtype == torch.float32 and got.shape == (2, 256)
    torch.testing.assert_close(got, ref.embed(params, x, WINDOW), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_bfloat16_within_the_port_bound(params, shape):
    x = volume((2,) + shape + (3,), 1)
    got = small_net(params).embed(x.bfloat16())
    assert mean_rel(got, ref.embed(params, x, WINDOW)) < BF16_VS_F32


_real = {"region_mask": vs.region_mask, "relative_position_index": vs.relative_position_index,
         "window_rows": vs.window_rows}
FAULTS = {
    "the shift mask dropped": ("region_mask",
                               lambda *a: np.zeros_like(_real["region_mask"](*a))),
    "the relative index transposed": ("relative_position_index",
                                      lambda w: _real["relative_position_index"](w).T),
    "the roll's sign flipped": ("window_rows", lambda dims, w, s: _real["window_rows"](
        dims, w, tuple(-i for i in s))),
    "PatchMerging's x1 and x2 swapped": ("MERGE_OFFSETS", ((0, 0), (0, 1), (1, 0), (1, 1))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_breaks_both_bounds(params, fault, monkeypatch):
    name, value = FAULTS[fault]
    monkeypatch.setattr(vs, name, value)
    x = volume((2, 8, 48, 48, 3), 2)
    want = ref.embed(params, x, WINDOW)
    got = small_net(params).embed(x)
    assert mean_rel(got, want) > 5 * BF16_VS_F32
    assert not torch.allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dims", [(16, 56, 56), (16, 7, 7), (4, 3, 3), (3, 12, 16)])
def test_the_geometry_is_the_published_code(dims):
    """The program's numpy geometry against the reference's literal code:
    the bias index, compute_mask, and the gathers against pad, roll and
    window_partition (and window_reverse and the roll back)."""
    window = (8, 7, 7) if dims[0] == 16 else WINDOW
    shift = tuple(w // 2 for w in window)
    use_window, use_shift = vs.get_window_size(dims, window, shift)
    assert (use_window, use_shift) == ref.get_window_size(dims, window, shift)
    np.testing.assert_array_equal(vs.relative_position_index(window),
                                  ref.relative_position_index(window).numpy())
    padded = [-(-n // w) * w for n, w in zip(dims, use_window)]
    np.testing.assert_array_equal(vs.region_mask(padded, use_window, use_shift),
                                  ref.compute_mask(*padded, use_window, use_shift, "cpu").numpy())
    src, back, windows = vs.window_rows(dims, use_window, use_shift)
    tokens = int(np.prod(dims))
    x = torch.arange(1, tokens + 1, dtype=torch.float32).view(1, *dims, 1)
    xp = torch.nn.functional.pad(x, (0, 0, 0, padded[2] - dims[2], 0, padded[1] - dims[1],
                                     0, padded[0] - dims[0]))
    if any(use_shift):
        xp = torch.roll(xp, tuple(-s for s in use_shift), (1, 2, 3))
    want = ref.window_partition(xp, use_window)[..., 0]          # [windows, N]
    got = torch.cat([x.view(-1), torch.zeros(1)])[torch.from_numpy(src)]
    torch.testing.assert_close(got.view(-1, windows).T, want, rtol=0, atol=0)
    np.testing.assert_array_equal(got[torch.from_numpy(back)].numpy(), x.view(-1).numpy())
    if dims == (16, 56, 56):
        assert windows == 128 and int(np.count_nonzero(vs.region_mask(
            padded, use_window, use_shift).any(axis=(1, 2)))) == 2 * 8 * 8 - 1 * 7 * 7


def test_the_counters_at_the_published_depth(monkeypatch):
    """Depths [2, 2, 18, 2] (tiny widths): 24 attention calls a forward, 12
    of them under a shift mask (1 + 1 + 9 + 1: on 4 x 3 x 3 and 4 x 2 x 2
    tokens only the time dim shifts), no W1 launch on the CPU, the views
    counted, and 1 + 48 + 3 + 1 LayerNorms, 48 residual adds and 48 window
    gathers a forward."""
    monkeypatch.setattr(profiling, "_state", profiling._State())
    net = vs.VideoSwin(vs.make_weights(7, embed_dim=32, depths=vs.DEPTHS, heads=(1, 2, 4, 8),
                                       window=WINDOW), window=WINDOW)
    with profile(activities=[ProfilerActivity.CPU]):
        net.embed(volume((3, 8, 48, 48, 3), 3))
    rec = profiling.trace_record()
    assert rec.counters == {"videoswin.views": 3, "videoswin.sdpa_calls": 24,
                            "videoswin.shifted_calls": 12, "videoswin.window_attn_launches": 0}
    totals = rec.totals()
    assert [totals[f"videoswin.{k}"]["calls"] for k in ("embed", "attn", "mlp", "merge",
                                                         "sdpa")] == [1, 24, 24, 3, 24]
    assert [totals[f"videoswin.{k}"]["calls"] for k in ("norm", "add", "window_gather")] == \
        [53, 48, 48]


def test_the_glue_spans_nest_in_their_layers_and_change_no_bit(params, monkeypatch):
    """In a CPU trace of the small net (depths [2, 2, 2, 2]) each
    LayerNorm, residual add and window gather is a span of its own inside
    the layer that runs it, the final norm inside the caller's span; the
    traced forward gives the untraced one's bits."""
    monkeypatch.setattr(profiling, "_state", profiling._State())
    net = small_net(params)
    x = volume((2, 8, 48, 48, 3), 4)
    want = net.embed(x)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("extract.rgb_net"):
            got = net.embed(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    rec = profiling.trace_record()
    by_id = {s.id: s for s in rec.spans}
    ordered = sorted(rec.spans, key=lambda s: s.start_ns)

    def parents(name):
        return [by_id[s.parent].name.split(".")[-1] for s in ordered if s.name == name]

    block = ["attn", "mlp"] * 2
    assert parents("videoswin.norm") == ["embed"] + (block + ["merge"]) * 3 + block + ["rgb_net"]
    assert parents("videoswin.add") == block * 4
    assert parents("videoswin.window_gather") == ["attn"] * 16
    assert all(not s.device_ms for s in rec.spans)           # no CUDA event on the CPU


def test_untraced_the_glue_spans_open_no_range(params, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a range opened while untraced")

    monkeypatch.setattr(profiling, "_state", profiling._State())
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    small_net(params).embed(volume((1, 8, 48, 48, 3), 5))
    assert profiling.trace_record() is None


def test_the_sampler_is_mmactions_test_mode_sample_frames():
    for n in range(1, 400):
        np.testing.assert_array_equal(multiview_frames(n, 32, 2, 4), ref.sample_frames(n))
        distinct, positions = view_frames(n, 32, 2, 4)
        np.testing.assert_array_equal(distinct[positions], ref.sample_frames(n))
        assert (np.diff(distinct) > 0).all()
    index = multiview_frames(250, 32, 2, 4)
    assert index[:, 0].tolist() == [23, 70, 116, 163]
    assert index[:, -1].tolist() == [85, 132, 178, 225]
    assert len(view_frames(250, 32, 2, 4)[0]) == 119
    # a 50-frame tail is shorter than one clip's 63-frame span: every clip
    # starts at 0 and its indices wrap mod 50
    short = multiview_frames(50, 32, 2, 4)
    assert (short == short[0]).all()
    assert short[0, :25].tolist() == list(range(0, 50, 2)) and short[0, 25] == 0


def test_the_three_crops_on_224_by_298():
    assert preprocess.short_side_size(340, 256, 224) == (298, 224)
    assert ref.rescale_size(340, 256, 224) == (298, 224)
    origins = [preprocess._crop_origin(224, 298, 224, w) for w in preprocess.THREE_CROP]
    assert origins == [(0, 0), (0, 74), (0, 37)]
    assert [preprocess._crop_origin(298, 224, 224, w) for w in preprocess.THREE_CROP] == \
        [(0, 0), (74, 0), (37, 0)]
    with pytest.raises(ValueError):
        preprocess._crop_origin(256, 340, 224, "mid")


def video_frames(n: int, seed: int = 0, h: int = 40, w: int = 60) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_the_views_are_the_reference_protocol():
    """The program's views of a segment, gathered from its distinct frames,
    against the reference's SampleFrames, Resize, ThreeCrop and Normalize
    (at 224 x 298 too)."""
    for n, (h, w), crop, clips in ((16, (40, 60), 32, 2), (50, (64, 88), 32, 2),
                                   (21, (256, 340), 224, 1)):
        frames = video_frames(n, 4, h, w)
        distinct, positions = view_frames(n, 4, 2, clips)
        got = preprocess.preprocess_rgb_videoswin(torch.from_numpy(frames[distinct][None]),
                                                  torch.from_numpy(positions), crop)
        want = ref.views(torch.from_numpy(frames), 4, 2, clips, crop, crop)
        assert got.shape == (1, 3 * clips, 4, crop, crop, 3)
        torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-4)


def test_the_config_is_rgb_only_and_1024_wide():
    cfg = ExtractionConfig(arch="videoswin")
    assert cfg.feature_dim == 1024 and cfg.rgb_only and not ExtractionConfig().rgb_only
    assert (cfg.view_clip_len, cfg.view_frame_interval, cfg.view_clips) == (32, 2, 4)
    assert ExtractionConfig(arch="timesformer").rgb_only
    for bad in (dict(feature_dim=768), dict(host_gray=True),
                dict(host_gray=True, host_crop=True)):
        with pytest.raises(ValueError):
            ExtractionConfig(arch="videoswin", **bad)


def test_the_payload_holds_the_distinct_view_frames():
    frames = video_frames(16 * 2 + 9)               # 2 segments and a 9-frame tail
    groups = plan_groups(len(frames), CFG)
    assert [nums for _g, nums in groups] == [[1, 2], [3]]
    for group, nums in groups:
        payload = build_payload(frames, None, group, nums, CFG, CFG.flow_res_div)
        f_len = group[0][1] - group[0][0] + 1
        distinct = view_frames(f_len, 4, 2, 2)[0]
        assert payload.gray is None and payload.f_len == f_len
        assert payload.clip_rgb.shape == (len(group), len(distinct), 40, 60, 3)
        for i, (s, _e) in enumerate(group):
            np.testing.assert_array_equal(payload.clip_rgb[i], frames[s - 1 + distinct])


@pytest.fixture(scope="module")
def tsn():
    """One small Video Swin member."""
    member = vs.VideoSwin(vs.make_weights(9, **SMALL), window=WINDOW)
    return TwoStreamTSN(StreamEnsemble([member], (1,), vs.RGB_CHANNELS), None)


def member_params(tsn) -> dict:
    params = {}
    for key, p in tsn.rgb.nets[0].params.items():
        layer, _sep, leaf = key.replace("__", "/").rpartition("/")
        params.setdefault(layer, {})[leaf] = p.detach().numpy()
    return params


def test_the_rgb_only_extractor_end_to_end(tsn, tmp_path):
    """Each segment's signature is the reference's mean over its 6 views;
    one 1024-d rgb member in the records and in the CSV tree, which the
    loader reads back."""
    frames = video_frames(16 * 2 + 9, 1)
    ex = te.Extractor(tsn, CFG, device="cpu")
    sigs = list(ex.extract_frames(frames))
    assert [s.clip_numbers for s in sigs] == [[1, 2], [3]]
    params = member_params(tsn)
    for sig, (group, _nums) in zip(sigs, plan_groups(len(frames), CFG)):
        assert sig.flow is None and sig.splits == (1,) and sig.rgb.shape == (1, len(group), 256)
        want = torch.stack([ref.segment_signature(params, torch.from_numpy(frames[s - 1:e]),
                                                  WINDOW, **PROTOCOL) for s, e in group])
        torch.testing.assert_close(sig.rgb[0], want, rtol=RTOL, atol=ATOL)
    recs = ex.records(sigs)
    assert {r.stream for r in recs} == {RGB} and len(recs) == 3
    paths = ex.write_csv_tree(sigs, str(tmp_path), "vid", "http://x/vid.mp4")
    assert [os.path.relpath(p, tmp_path) for p in paths] == [
        os.path.join("vid", "Kinetics400_VideoSwin_split1", f"{RGB}_global_pool_features.csv")]
    loaded = []
    for video, split, csv in read_feature_tree(str(tmp_path)):
        assert (video, split, csv.stream) == ("vid", 1, RGB)
        assert csv.weights_uri == "kinetics400_swin_base_patch244_window877_22k_rgb.npz"
        loaded += [FeatureRecord(int(c), csv.stream, split, csv.feature_blob, f)
                   for c, f in zip(csv.clip_numbers, csv.features)]
    index = FeatureIndex.build(loaded, (RGB,), device="cpu")
    assert index.feature_dim == 256 and index.clip_ids.tolist() == [1, 2, 3]


def test_a_1024_wide_member_writes_1024_wide_csvs(tmp_path):
    """At the published embedding width the signature is 1,024-d, which
    the CSV tree and the index carry."""
    member = vs.VideoSwin(vs.make_weights(2, depths=(1, 1, 1, 1), heads=(1, 1, 1, 1),
                                          window=WINDOW), window=WINDOW)
    tsn = TwoStreamTSN(StreamEnsemble([member], (1,), 3), None)
    cfg = ExtractionConfig(arch="videoswin", fps=4, clip_seconds=4, frame_resize=(60, 40),
                           crop_size=32, batch_clips=1, view_clip_len=4, view_clips=1)
    ex = te.Extractor(tsn, cfg, device="cpu", dtype="bfloat16")
    sigs = list(ex.extract_frames(video_frames(16, 5)))
    assert sigs[0].rgb.shape == (1, 1, cfg.feature_dim) == (1, 1, 1024)
    ex.write_csv_tree(sigs, str(tmp_path), "vid", "http://x/vid.mp4")
    [(_video, _split, csv)] = read_feature_tree(str(tmp_path))
    assert np.asarray(csv.features).shape == (1, 1024)


def test_the_step_halves_give_the_dispatched_bits(tsn):
    frames = video_frames(16 * 2, 2)
    [(group, nums)] = plan_groups(len(frames), CFG)
    payload = build_payload(frames, None, group, nums, CFG, CFG.flow_res_div)
    ex = te.Extractor(tsn, CFG, device="cpu", dtype="bfloat16")
    sig = ex._dispatch_payload(payload)
    plan = ex._plan(payload.f_len)
    rgb_in, flow_in = te.prepare_step(torch.from_numpy(payload.clip_rgb), plan, CFG, False,
                                      ex.tvl1, "bfloat16")
    assert flow_in is None and rgb_in.dtype == torch.bfloat16
    assert rgb_in.shape == (2, 6, 4, 32, 32, 3)
    rgb, flow = te.embed_step(tsn, rgb_in, flow_in)
    assert flow is None and torch.equal(rgb, sig.rgb)
    assert plan.tick_idx.tolist() == view_frames(16, 4, 2, 2)[1].tolist()


def test_the_extractor_refuses_networks_of_another_architecture(tsn):
    with pytest.raises(ValueError):
        te.Extractor(tsn, ExtractionConfig(), device="cpu")
    with pytest.raises(ValueError):
        te.Extractor(tsn, ExtractionConfig(arch="timesformer"), device="cpu")
    assert tsn.rgb.arch == "videoswin" and tsn.rgb.temporal
    tree = vs.make_weights(3, embed_dim=32, depths=(1, 1, 1, 1), heads=(1, 1, 1, 1))
    rebuilt = StreamEnsemble.from_jax_params({1: tree}, 3, "cpu")
    assert isinstance(rebuilt.nets[0], vs.VideoSwin) and rebuilt.nets[0].depths == [1] * 4
    with pytest.raises(ValueError):
        vs.VideoSwin(vs.make_weights(3, embed_dim=32, depths=(1, 1, 1, 1), window=WINDOW))


def test_the_spans_and_the_counters_in_a_cpu_trace(tsn, monkeypatch):
    monkeypatch.setattr(profiling, "_state", profiling._State())
    cfg = ExtractionConfig(arch="videoswin", fps=4, clip_seconds=4, frame_resize=(60, 40),
                           crop_size=32, batch_clips=1, view_clip_len=4, view_clips=2)
    ex = te.Extractor(tsn, cfg, device="cpu")
    frames = video_frames(16, 3)
    [(group, nums)] = plan_groups(len(frames), cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        ex._dispatch_payload(build_payload(frames, None, group, nums, cfg, 2))
    rec = profiling.trace_record()
    by_id = {s.id: s for s in rec.spans}
    ordered = sorted(rec.spans, key=lambda s: s.start_ns)
    kinds = ("videoswin.embed", "videoswin.attn", "videoswin.mlp", "videoswin.merge")
    nested = [(s.name, by_id[s.parent].name) for s in ordered if s.name in kinds]
    stage = [("videoswin.attn", "extract.rgb_net"), ("videoswin.mlp", "extract.rgb_net")] * 2
    assert nested == ([("videoswin.embed", "extract.rgb_net")]
                      + (stage + [("videoswin.merge", "extract.rgb_net")]) * 3 + stage)
    assert [by_id[s.parent].name for s in ordered if s.name == "videoswin.sdpa"] == \
        ["videoswin.attn"] * 8
    # 2 clips x 3 crops; 40x60 frames give 2 x 8 x 12 tokens, whose first two
    # stages shift in H and W
    assert rec.counters == {"videoswin.views": 6, "videoswin.sdpa_calls": 8,
                            "videoswin.shifted_calls": 2, "videoswin.window_attn_launches": 0}
    assert not {"extract.flow", "extract.flow_net", "extract.inflight_wait"} & set(rec.totals())


def test_the_cli_writes_the_videoswin_tree(tmp_path, monkeypatch):
    monkeypatch.setenv("VIDEOQUERY_DEVICE", "cpu")
    video = decode.synthesize_video(str(tmp_path / "v.mp4"), n_frames=56, size=(88, 64))
    out = tmp_path / "feats"
    built = []

    def small_random(seed, splits, device, arch):
        built.append((splits, arch))
        member = vs.VideoSwin(vs.make_weights(seed, embed_dim=32, depths=(1, 1, 1, 1),
                                              heads=(1, 1, 1, 1), window=WINDOW),
                              window=WINDOW)
        return TwoStreamTSN(StreamEnsemble([member], splits, 3), None)

    monkeypatch.setattr(te.TwoStreamTSN, "random", staticmethod(small_random))
    te.main([video, "--out", str(out), "--arch", "videoswin", "--clip_time", "1",
             "--new_width", "88", "--new_height", "64", "--batch_clips", "1"])
    assert built == [((1,), "videoswin")]
    d = out / "v" / "Kinetics400_VideoSwin_split1"
    assert sorted(os.listdir(d)) == [f"{RGB}_global_pool_features.csv"]
    assert FLOW not in {csv.stream for _v, _s, csv in read_feature_tree(str(out))}
    # fps 25 by default: 55 usable frames are two 25-frame segments, each
    # shorter than one clip's 63-frame span (every view wraps)
    [(_video, _split, csv)] = read_feature_tree(str(out))
    assert list(csv.clip_numbers) == [1, 2]
    with pytest.raises(SystemExit):
        te.main([video, "--out", str(out), "--arch", "videoswin", "--weights", str(tmp_path)])
