"""I3D (``videoquery_torch/nn/i3d.py``) and its place on the extraction path,
against the plain reference ``videoquery_torch/testing/i3d_reference.py``
on seeded random weights, at the published widths and small volumes.

- Float32: rtol 1e-4 / atol 1e-5, as the BN-Inception tests
  (``tests/test_torch_nn.py``). The port and the reference do the same f32
  arithmetic but pad in another way (the conv's own symmetric padding
  against an explicit ``F.pad``) on another memory layout (channels-last-3d
  against NCDHW), so oneDNN may pick other algorithms and sum in another
  order through 57 convs: the differences seen are ~1e-7 of the largest
  value.
- bfloat16 against the float32 reference: mean |port - reference| / mean
  |reference| < 2%. Each of 57 convs rounds its bf16 inputs and its output
  (8 bits of mantissa, 2^-9 relative a rounding); measured ~0.5%, about
  what BN-Inception reads over its 69 convs. The same reference with
  per-tensor scaled float8 e4m3 operands (3 bits) reads several times the
  bound, so the bound tells the configuration's precision from the one
  below it.
"""

import math
import os

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videoquery_torch.core import profiling
from videoquery_torch.core.config import FLOW, RGB, ExtractionConfig
from videoquery_torch.index.csvio import read_feature_tree
from videoquery_torch.index.records import FeatureRecord
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.kernels import stem_conv3d
from videoquery_torch.nn import i3d
from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN
from videoquery_torch.pipeline import decode
from videoquery_torch.pipeline import extract as te
from videoquery_torch.pipeline.payload import build_payload, plan_groups
from videoquery_torch.pipeline.sampling import flow_warm_plan
from videoquery_torch.testing import i3d_reference as ref
from videoquery_torch.testing import multihost_worker as mw

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
BF16_VS_F32 = 0.02

# 2 segments of 16 frames a batch at 64x88, cropped to 64x64
CFG = ExtractionConfig(arch="i3d", fps=4, clip_seconds=4, frame_resize=(88, 64),
                       crop_size=64, batch_clips=2)


def mean_rel(got, want) -> float:
    return float((got - want).abs().mean() / want.abs().mean())


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = 448.0 / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


@pytest.fixture(scope="module")
def params():
    return {c: i3d.init_params(7 + c, c) for c in (i3d.RGB_CHANNELS, i3d.FLOW_CHANNELS)}


def volume(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 2 - 1


def test_published_widths_and_layer_list():
    convs = i3d.conv_layers(3)
    assert len(convs) == 3 + 9 * 6
    # weights alone (the folded biases are one a channel): 12.27 M rgb, 12.25 M flow
    for c, want in ((3, 12_272_704), (2, 12_250_752)):
        assert sum(math.prod(k) * ci * co for _n, k, _s, ci, co in i3d.conv_layers(c)) == want
    outs = {name: b0 + b1b + b2b + b3 for name, (b0, _a, b1b, _c, b2b, b3) in i3d.MIXED.items()}
    assert outs == {"Mixed_3b": 256, "Mixed_3c": 480, "Mixed_4b": 512, "Mixed_4c": 512,
                    "Mixed_4d": 512, "Mixed_4e": 528, "Mixed_4f": 832, "Mixed_5b": 832,
                    "Mixed_5c": 1024}
    assert [layer[1] for layer in i3d.LAYERS] == [
        "Conv3d_1a_7x7", "MaxPool3d_2a_3x3", "Conv3d_2b_1x1", "Conv3d_2c_3x3",
        "MaxPool3d_3a_3x3", "Mixed_3b", "Mixed_3c", "MaxPool3d_4a_3x3", "Mixed_4b",
        "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f", "MaxPool3d_5a_2x2", "Mixed_5b",
        "Mixed_5c"]
    assert [layer[1] for layer in i3d.LAYERS[:i3d.STEM_LAYERS]][-1] == "MaxPool3d_3a_3x3"
    assert dict(ref.MIXED_WIDTHS) == dict(i3d.MIXED)
    # Xavier-uniform convs, zero biases, a N(0, 1/1024) head
    p = i3d.init_params(0)
    w = p["Mixed_4c/Branch_1/Conv3d_0b_3x3"]["w"]
    assert w.shape == (3, 3, 3, 112, 224)
    assert np.abs(w).max() <= math.sqrt(6.0 / (27 * 112 + 27 * 224))
    assert not any(v["b"].any() for v in p.values())
    assert p[i3d.LOGITS]["w"].shape == (1024, 400)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 15, 16, 63, 64, 65, 125, 224, 249, 250])
@pytest.mark.parametrize("k, s", [(1, 1), (3, 1), (3, 2), (7, 2), (2, 2), (1, 2)])
def test_same_padding_is_tensorflows_rule(n, k, s):
    before, after = i3d.same_padding(n, k, s)
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    assert (before, after) == (total // 2, total - total // 2) == ref.same_pads(n, k, s)
    # the padded axis holds exactly ceil(n / s) windows
    assert (n + before + after - k) // s + 1 == out


SIZES = [(9, 33, 31), (8, 32, 32), (7, 16, 17), (4, 14, 14)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("k, s", [((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2)),
                                  ((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))])
def test_same_max_pool_at_odd_and_even_sizes(size, k, s):
    """The pools pad with -inf, the odd cell at the end: the same maxima as
    the reference's explicit F.pad, channels-last-3d kept."""
    x = volume((1, 4) + size).contiguous(memory_format=torch.channels_last_3d)
    got = i3d.max_pool_same(x, k, s)
    assert got.shape[2:] == tuple(-(-n // st) for n, st in zip(size, s))
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(got, ref.max_pool(x, k, s), rtol=0, atol=0)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("k, s", [((7, 7, 7), (2, 2, 2)), ((3, 3, 3), (1, 1, 1)),
                                  ((1, 1, 1), (1, 1, 1))])
def test_same_conv_at_odd_and_even_sizes(size, k, s):
    """The convs pad with zeros, the odd cell at the end (the op's own
    padding where SAME is even); the stride-2 stem as S1's plain version."""
    x = volume((1, 3) + size).contiguous(memory_format=torch.channels_last_3d)
    g = torch.Generator().manual_seed(1)
    w = torch.randn(5, 3, *k, generator=g)
    params = {"c": {"w": w.permute(2, 3, 4, 1, 0).numpy(), "b": np.zeros(5, np.float32)}}
    if s == i3d.ONE:
        xin, pad = i3d.conv_input(x, k, s)
        got = torch.relu(torch.nn.functional.conv3d(xin, w, padding=pad))
    else:
        got = stem_conv3d.stem_conv_reference(x, w, torch.zeros(5))
    want = ref.unit3d(params, "c", x, s)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("channels", [i3d.RGB_CHANNELS, i3d.FLOW_CHANNELS])
def test_forward_and_embed_match_the_reference_in_f32(params, channels):
    net = i3d.InceptionI3d(params[channels])
    x = volume((2, 16, 64, 64, channels), seed=channels)
    got, want = net(x), ref.forward(params[channels], x)
    for key in ("global_pool", "logits"):
        assert got[key].shape == want[key].shape
        torch.testing.assert_close(got[key], want[key], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(net.embed(x), want["global_pool"], rtol=RTOL, atol=ATOL)
    # an odd size, where SAME pads unevenly in every axis
    x = volume((1, 15, 63, 65, channels), seed=3)
    torch.testing.assert_close(net.embed(x), ref.embed(params[channels], x),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("channels", [i3d.RGB_CHANNELS, i3d.FLOW_CHANNELS])
def test_bf16_against_the_f32_reference(params, channels):
    net = i3d.InceptionI3d(params[channels])
    x = volume((2, 16, 64, 64, channels), seed=channels)
    want = ref.forward(params[channels], x)
    got = net(x.bfloat16())
    for key in ("global_pool", "logits"):
        assert got[key].dtype == torch.float32
        assert mean_rel(got[key], want[key]) < BF16_VS_F32
    # the precision below bf16 fails the bound
    low = ref.embed(params[channels], fp8(x), cast=fp8)
    assert mean_rel(low, want["global_pool"]) > BF16_VS_F32


def test_the_dense_step_plan():
    for f_len in (16, 11):
        plan = te.step_plan(f_len, CFG, "pallas", "cpu")
        assert plan.tick_idx.tolist() == list(range(f_len))
        assert plan.pair_idx.tolist() == list(range(f_len - 1))
        assert plan.stack_pos is None
        want = flow_warm_plan(np.arange(f_len - 1), CFG.flow_warm_group)
        for got, w in zip(plan.warm, want):
            assert got.tolist() == w.tolist()
    full = ExtractionConfig(arch="i3d", fps=25)
    plan = te.step_plan(full.frames_per_clip, full, "pallas", "cpu")
    assert plan.tick_idx.shape == (250,) and plan.pair_idx.shape == (249,)
    with pytest.raises(ValueError):
        te.step_plan(16, CFG, "xla", "cpu")
    with pytest.raises(ValueError):
        ExtractionConfig(arch="i3d", host_gray=True)
    with pytest.raises(ValueError):
        ExtractionConfig(arch="c3d")


@pytest.fixture(scope="module")
def tsn():
    return TwoStreamTSN.random(3, (1,), "cpu", arch="i3d")


@pytest.fixture(scope="module")
def payload():
    video = mw.extract_world_video(n_frames=32, h=64, w=88)
    [(group, nums)] = plan_groups(len(video), CFG)
    return build_payload(video, None, group, nums, CFG, CFG.flow_res_div)


def _cv2_resize_crop(x: np.ndarray, w: int, h: int, size: int) -> np.ndarray:
    """[..., H, W, C] f32 -> cv2.resize INTER_LINEAR to (w, h), center crop."""
    lead = x.shape[:-3]
    flat = x.reshape((-1,) + x.shape[-3:])
    top, left = (h - size) // 2, (w - size) // 2
    out = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR).reshape(h, w, -1)
                    [top:top + size, left:left + size] for f in flat])
    return out.reshape(lead + out.shape[1:])


def reference_signatures(tsn, payload, tvl1) -> dict:
    """The reference pipeline: the port's flow of every consecutive pair
    (unwarped, the rescue decided at once), the inputs made here with cv2
    and numpy, the reference network."""
    frames = torch.from_numpy(payload.clip_rgb)
    b, f, h0, w0 = frames.shape[:4]
    plan = te.step_plan(f, CFG, "pallas", "cpu")
    gray, (sx, sy) = te._flow_gray(frames, CFG, None, None)
    u, v = te._pair_flow_uv(gray, plan.pair_idx, False, tvl1, plan.warm, CFG.flow_warm_camera)
    uv = np.clip(torch.stack([u * sx, v * sy], -1).numpy(), -20.0, 20.0) / 20.0
    flow = _cv2_resize_crop(uv, 88, 64, 64)
    rgb = _cv2_resize_crop(payload.clip_rgb.astype(np.float32), 88, 64, 64)[..., ::-1] / 127.5 - 1.0
    out = {}
    for key, stream, x in (("rgb", tsn.rgb, rgb), ("flow", tsn.flow, flow)):
        net = stream.nets[0]
        params = {name.replace("__", "/"): {"w": w.permute(2, 3, 4, 1, 0).numpy(),
                                            "b": net.biases[name].numpy()}
                  for name, w in net.weights.items()}
        params[i3d.LOGITS] = {"w": net.logits_w.numpy(), "b": net.logits_b.numpy()}
        out[key] = ref.embed(params, torch.from_numpy(np.ascontiguousarray(x, np.float32)))
    return out


@pytest.mark.parametrize("dtype, bound", [("float32", 1e-4), ("bfloat16", BF16_VS_F32)])
def test_a_dispatched_batch_against_the_reference_pipeline(tsn, payload, dtype, bound):
    ex = te.Extractor(tsn, CFG, tvl1=mw.extract_world_tvl1(), device="cpu", dtype=dtype)
    assert not ex.warped                      # I3D's flow is plain TV-L1
    sig = ex._dispatch_payload(payload)
    assert sig.clip_numbers == [1, 2] and sig.splits == (1,)
    assert sig.rgb.shape == sig.flow.shape == (1, 2, 1024)
    want = reference_signatures(tsn, payload, ex.tvl1)
    for key, got in (("rgb", sig.rgb[0]), ("flow", sig.flow[0])):
        assert mean_rel(got, want[key]) < bound, key
    # the rescue decided at once gives the same bits
    plan = ex._plan(payload.f_len)
    rgb, flow = te.embed_step(tsn, *te.prepare_step(torch.from_numpy(payload.clip_rgb), plan,
                                                    CFG, False, ex.tvl1, dtype))
    assert torch.equal(rgb, sig.rgb) and torch.equal(flow, sig.flow)


def test_the_extractor_refuses_members_of_another_architecture(tsn):
    with pytest.raises(ValueError):
        te.Extractor(tsn, ExtractionConfig(), device="cpu")
    with pytest.raises(ValueError):
        te.Extractor(TwoStreamTSN.random(0, (1,), "cpu"), CFG, device="cpu")
    assert tsn.rgb.temporal and tsn.flow.temporal and tsn.flow.in_channels == 2
    # the constructors build the member the parameters describe
    rebuilt = StreamEnsemble.from_jax_params({1: i3d.init_params(3 + 1, 3)}, 3, "cpu")
    assert isinstance(rebuilt.nets[0], i3d.InceptionI3d)
    assert torch.equal(rebuilt.nets[0].weights["Conv3d_1a_7x7"],
                       tsn.rgb.nets[0].weights["Conv3d_1a_7x7"])


def test_the_csv_tree_loads_as_an_index_of_one_split(tsn, payload, tmp_path):
    ex = te.Extractor(tsn, CFG, tvl1=mw.extract_world_tvl1(), device="cpu")
    sigs = [ex._dispatch_payload(payload)]
    paths = ex.write_csv_tree(sigs, str(tmp_path), "vid", "http://x/vid.mp4")
    assert sorted(os.path.relpath(p, tmp_path) for p in paths) == [
        os.path.join("vid", "Kinetics400_I3D_split1", f"{s}_global_pool_features.csv")
        for s in (RGB, FLOW)]
    recs = []
    for video, split, csv in read_feature_tree(str(tmp_path)):
        assert (video, split) == ("vid", 1)
        assert csv.weights_uri == f"kinetics400_i3d_{'rgb' if csv.stream == RGB else 'flow'}.npz"
        recs += [FeatureRecord(int(c), csv.stream, split, csv.feature_blob, f)
                 for c, f in zip(csv.clip_numbers, csv.features)]
    index = FeatureIndex.build(recs, (RGB, FLOW), device="cpu")
    assert index.splits == (1,) and index.clip_ids.tolist() == [1, 2]
    host = te.gather_signatures(sigs)[0]
    for si, arr in ((0, host.rgb), (1, host.flow)):
        np.testing.assert_array_equal(index.feats[si, 0, :2].numpy(), arr[0])


def test_the_spans_nest_in_a_cpu_trace(tsn, payload, monkeypatch):
    monkeypatch.setattr(profiling, "_state", profiling._State())
    ex = te.Extractor(tsn, CFG, tvl1=mw.extract_world_tvl1(), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        ex._dispatch_payload(payload)
    rec = profiling.trace_record()
    by_id = {s.id: s for s in rec.spans}
    ordered = sorted(rec.spans, key=lambda s: s.start_ns)
    nested = [(s.name, by_id[s.parent].name) for s in ordered
              if s.name in ("i3d.stem", "i3d.mixed")]
    assert nested == [("i3d.stem", "extract.rgb_net"), ("i3d.mixed", "extract.rgb_net"),
                      ("i3d.stem", "extract.flow_net"), ("i3d.mixed", "extract.flow_net")]
    # the 13 pools of each forward: 2 in the stem, 11 among the Mixed blocks
    pools = [by_id[s.parent].name for s in ordered if s.name == "i3d.pool"]
    assert pools == (["i3d.stem"] * 2 + ["i3d.mixed"] * 11) * 2
    assert rec.counters["extract.flow_pairs"] == 2 * 15
    # the stem conv of each forward, inside the stem
    convs = [by_id[s.parent].name for s in ordered if s.name == "i3d.stem_conv"]
    assert convs == ["i3d.stem"] * 2
    # the CPU takes the plain pool and stem conv: no kernel launch
    assert rec.counters["i3d.pool_launches"] == 0
    assert rec.counters["i3d.stem_conv_launches"] == 0


def test_the_cli_writes_the_i3d_tree(tmp_path, monkeypatch):
    monkeypatch.setenv("VIDEOQUERY_DEVICE", "cpu")
    video = decode.synthesize_video(str(tmp_path / "v.mp4"), n_frames=18, size=(88, 64))
    out = tmp_path / "feats"
    te.main([video, "--out", str(out), "--arch", "i3d", "--fps", "4", "--clip_time", "4",
             "--new_width", "88", "--new_height", "64", "--batch_clips", "1"])
    d = out / "v" / "Kinetics400_I3D_split1"
    assert sorted(os.listdir(d)) == [f"{s}_global_pool_features.csv" for s in (RGB, FLOW)]
    with pytest.raises(SystemExit):
        te.main([video, "--out", str(out), "--arch", "i3d", "--weights", str(tmp_path)])
