"""TimeSformer (``videoquery_torch/nn/timesformer.py``) and the rgb-only
extraction path it runs on, against the plain reference
``videoquery_torch/testing/timesformer_reference.py`` on seeded random
weights, at small sizes on the CPU.

- Float32: rtol 1e-5 / atol 1e-5 on signatures of unit scale (the final
  LayerNorm's output). The port and the reference do the same f32
  arithmetic in another order (a GEMM over the patches against vit.py's
  conv, SDPA's softmax against the explicit one, the embeddings summed
  first, in-place residual adds). The reference's own patch conv is
  already ~3e-6 from the float64 value at the embedding's scale (~3.5),
  and the differences reach ~1.4e-6 at the signature, so an atol of 1e-6
  would fail near-zero elements on rounding alone; 1e-5 is ~80 float32
  ulps at 1, and 200 times below one bf16 rounding.
- bfloat16 against the float32 reference: mean |port - reference| / mean
  |reference| < 2%, the port's bound for bf16 networks
  (``tests/test_torch_nn.py``). Every linear, LayerNorm and residual add
  rounds to 8 bits of mantissa; measured ~1% at the small sizes here.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from videoquery_torch.core import profiling
from videoquery_torch.core.config import FLOW, RGB, ExtractionConfig
from videoquery_torch.index.csvio import read_feature_tree
from videoquery_torch.index.records import FeatureRecord
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.nn import timesformer as tf
from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN
from videoquery_torch.pipeline import decode
from videoquery_torch.pipeline import extract as te
from videoquery_torch.pipeline.payload import build_payload, plan_groups
from videoquery_torch.pipeline.temporal_sampling import linspace_frames
from videoquery_torch.testing import timesformer_reference as ref

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-5
BF16_VS_F32 = 0.02

# 4 frames of 32x32 (4 patches a frame), D 64, 4 heads, 2 blocks, MLP 256
SMALL = dict(depth=2, dim=64, mlp_dim=256, frames=4, crop=32)
SMALL_HEADS = 4

# segments of 16 frames at 40x44, 4 of them sampled, cropped to 32x32
CFG = ExtractionConfig(arch="timesformer", fps=4, clip_seconds=4, frame_resize=(44, 40),
                       crop_size=32, batch_clips=2, num_frames=4)


def mean_rel(got, want) -> float:
    return float((got - want).abs().mean() / want.abs().mean())


def with_layer_norm_affine(params: dict, seed: int) -> dict:
    """params with every LayerNorm's weight and bias drawn (1 + N(0, 0.1^2),
    N(0, 0.1^2)), so the checks see their affine part too."""
    rng = np.random.default_rng(seed)
    out = {k: dict(v) for k, v in params.items()}
    for layer, leaf in out.items():
        if layer.split("/")[-1] in ("temporal_norm1", "norm1", "norm2", "norm"):
            leaf["w"] = (1 + 0.1 * rng.standard_normal(leaf["w"].shape)).astype(np.float32)
            leaf["b"] = (0.1 * rng.standard_normal(leaf["b"].shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def params():
    return with_layer_norm_affine(tf.make_weights(5, **SMALL), 6)


def volume(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


def small_net(params):
    return tf.TimeSformer(params, heads=SMALL_HEADS)


def test_published_widths():
    shapes = tf.layer_shapes()
    total = sum(int(np.prod(s)) for _l, _k, s in shapes)
    head = sum(int(np.prod(s)) for layer, _k, s in shapes if layer == tf.HEAD)
    assert (total, total - head) == (121_633_936, 121_326_336)
    assert tf.DIM // tf.HEADS == 64 and tf.DEPTH == 12 and tf.MLP_DIM == 3072
    net = tf.TimeSformer(tf.make_weights(0, depth=1))
    assert (net.dim, net.frames, net.patches, net.heads) == (768, 96, 196, 12)
    assert 1 + net.patches * net.frames == 18_817


def test_float32_against_the_reference(params):
    x = volume((2, 4, 32, 32, 3))
    got = small_net(params).embed(x)
    assert got.dtype == torch.float32 and got.shape == (2, 64)
    torch.testing.assert_close(got, ref.embed(params, x, SMALL_HEADS), rtol=RTOL, atol=ATOL)


def test_bfloat16_within_the_port_bound(params):
    x = volume((2, 4, 32, 32, 3), 1)
    got = small_net(params).embed(x.bfloat16())
    assert mean_rel(got, ref.embed(params, x, SMALL_HEADS)) < BF16_VS_F32


def test_the_time_path_is_live(params):
    """Swapping two frames moves the signature (the time embeddings), and
    so does a zero temporal_fc (the time attention's whole contribution);
    the program follows the reference in both."""
    net = small_net(params)
    x = volume((1, 4, 32, 32, 3), 2)
    base = net.embed(x)
    swapped = x[:, [1, 0, 2, 3]]
    assert mean_rel(net.embed(swapped), base) > 1e-2
    torch.testing.assert_close(net.embed(swapped), ref.embed(params, swapped, SMALL_HEADS),
                               rtol=RTOL, atol=ATOL)
    no_time = {k: dict(v) for k, v in params.items()}
    for layer, leaf in no_time.items():
        if layer.endswith("/temporal_fc"):
            leaf["w"], leaf["b"] = np.zeros_like(leaf["w"]), np.zeros_like(leaf["b"])
    got = small_net(no_time).embed(x)
    assert mean_rel(got, base) > 1e-2
    torch.testing.assert_close(got, ref.embed(no_time, x, SMALL_HEADS), rtol=RTOL, atol=ATOL)


def test_the_cls_token_gains_the_frame_mean_of_its_spatial_rows(params):
    """One block's space step: the CLS token gains the mean over the frames
    of the CLS row of each frame's own [CLS; patches] attention."""
    net = small_net(params)
    x = volume((2, 4, 32, 32, 3), 3)
    w = net._weights(x)
    tokens = net._embed_tokens(w, x)
    net._time_attn(w, 0, tokens, 4)
    before = tokens.clone()
    net._space_attn(w, 0, tokens, 4)
    b, _n, d = before.shape
    patches = before[:, 1:].view(b, 4, 4, d)                       # (h w) x t
    norm = params["blocks/0/norm1"]
    rows = []
    for f in range(4):
        frame = torch.cat([before[:, :1], patches[:, :, f]], dim=1)   # [B, 1 + N, D]
        z = F.layer_norm(frame, (d,), torch.from_numpy(norm["w"]), torch.from_numpy(norm["b"]),
                         tf.LN_EPS)
        rows.append(ref.attention(params, "blocks/0/attn", z, SMALL_HEADS)[:, 0])
    want = torch.stack(rows, dim=1).mean(dim=1)
    torch.testing.assert_close(tokens[:, 0] - before[:, 0], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num", [1, 2, 8, 16, 95, 96])
def test_the_sampler_is_pyslowfasts_linspace_rule(num):
    for n in range(1, 700):
        np.testing.assert_array_equal(linspace_frames(n, num), ref.sample_indices(n, num).numpy())
    # the segment's ends are its first and last frames
    assert linspace_frames(250, 96)[[0, -1]].tolist() == [0, 249]


def test_the_config_is_rgb_only_and_768_wide():
    assert CFG.feature_dim == 768 and ExtractionConfig().feature_dim == 1024
    assert ExtractionConfig(arch="i3d").feature_dim == 1024
    with pytest.raises(ValueError):
        ExtractionConfig(arch="timesformer", feature_dim=1024)
    with pytest.raises(ValueError):
        ExtractionConfig(arch="timesformer", host_gray=True)
    with pytest.raises(ValueError):
        ExtractionConfig(arch="timesformer", host_gray=True, host_crop=True)


def video_frames(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 40, 44, 3), dtype=np.uint8)


def test_the_payload_holds_only_the_sampled_frames():
    frames = video_frames(16 * 2 + 9)               # 2 segments and a 9-frame tail
    groups = plan_groups(len(frames), CFG)
    assert [nums for _g, nums in groups] == [[1, 2], [3]]
    for group, nums in groups:
        payload = build_payload(frames, None, group, nums, CFG, CFG.flow_res_div)
        f_len = group[0][1] - group[0][0] + 1
        assert payload.gray is None and payload.f_len == f_len
        assert payload.clip_rgb.shape == (len(group), 4, 40, 44, 3)
        assert payload.nbytes == len(group) * 4 * 40 * 44 * 3
        for i, (s, _e) in enumerate(group):
            np.testing.assert_array_equal(payload.clip_rgb[i],
                                          frames[s - 1 + linspace_frames(f_len, 4)])


@pytest.fixture(scope="module")
def tsn():
    """One TimeSformer member at the published width, 1 block, 4 frames of
    32x32."""
    member = tf.TimeSformer(tf.make_weights(9, depth=1, frames=4, crop=32))
    return TwoStreamTSN(StreamEnsemble([member], (1,), tf.RGB_CHANNELS), None)


def reference_signatures(tsn, frames: np.ndarray, group) -> torch.Tensor:
    """[B, 768]: each clip's frames sampled, cropped and normalised, and
    embedded by the reference."""
    params = {}
    for key, p in tsn.rgb.nets[0].params.items():
        layer, _sep, leaf = key.replace("__", "/").rpartition("/")
        params.setdefault(layer, {})[leaf] = p.detach().numpy()
    clips = []
    for s, e in group:
        clip = torch.from_numpy(frames[s - 1:e])
        clips.append(ref.preprocess(clip[ref.sample_indices(e - s + 1, 4)], 32))
    return ref.embed(params, torch.stack(clips))


def test_the_rgb_only_extractor_end_to_end(tsn, tmp_path):
    frames = video_frames(16 * 2 + 9, 1)
    ex = te.Extractor(tsn, CFG, device="cpu")
    sigs = list(ex.extract_frames(frames))
    assert [s.clip_numbers for s in sigs] == [[1, 2], [3]]
    for sig, (group, _nums) in zip(sigs, plan_groups(len(frames), CFG)):
        assert sig.flow is None and sig.splits == (1,) and sig.rgb.shape == (1, len(group), 768)
        torch.testing.assert_close(sig.rgb[0], reference_signatures(tsn, frames, group),
                                   rtol=RTOL, atol=ATOL)
    # one stream in the records and in the CSV tree, which the loader reads back
    recs = ex.records(sigs)
    assert {r.stream for r in recs} == {RGB} and len(recs) == 3
    paths = ex.write_csv_tree(sigs, str(tmp_path), "vid", "http://x/vid.mp4")
    assert [os.path.relpath(p, tmp_path) for p in paths] == [
        os.path.join("vid", "Kinetics400_TimeSformer_split1", f"{RGB}_global_pool_features.csv")]
    loaded = []
    for video, split, csv in read_feature_tree(str(tmp_path)):
        assert (video, split, csv.stream) == ("vid", 1, RGB)
        assert csv.weights_uri == "kinetics400_timesformer_divst_96x4_224_rgb.npz"
        loaded += [FeatureRecord(int(c), csv.stream, split, csv.feature_blob, f)
                   for c, f in zip(csv.clip_numbers, csv.features)]
    index = FeatureIndex.build(loaded, (RGB,), device="cpu")
    assert index.feature_dim == 768 and index.clip_ids.tolist() == [1, 2, 3]
    host = te.gather_signatures(sigs)
    np.testing.assert_array_equal(index.feats[0, 0, :3].numpy(),
                                  np.concatenate([h.rgb[0] for h in host]))


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
    rgb, flow = te.embed_step(tsn, rgb_in, flow_in)
    assert flow is None and torch.equal(rgb, sig.rgb)
    assert plan.tick_idx.tolist() == linspace_frames(16, 4).tolist()


def test_the_extractor_refuses_networks_of_another_architecture(tsn):
    with pytest.raises(ValueError):
        te.Extractor(tsn, ExtractionConfig(), device="cpu")
    with pytest.raises(ValueError):
        te.Extractor(TwoStreamTSN.random(0, (1,), "cpu"), CFG, device="cpu")
    assert tsn.rgb.arch == "timesformer" and tsn.rgb.temporal
    rebuilt = StreamEnsemble.from_jax_params({1: tf.make_weights(3, depth=1)}, 3, "cpu")
    assert isinstance(rebuilt.nets[0], tf.TimeSformer) and rebuilt.nets[0].depth == 1


def test_the_spans_and_the_counter_in_a_cpu_trace(params, monkeypatch):
    monkeypatch.setattr(profiling, "_state", profiling._State())
    member = small_net(params)
    cfg = ExtractionConfig(arch="timesformer", fps=4, clip_seconds=4, frame_resize=(44, 40),
                           crop_size=32, batch_clips=1, num_frames=4)
    ex = te.Extractor(TwoStreamTSN(StreamEnsemble([member], (1,), 3), None), cfg, device="cpu")
    frames = video_frames(16, 3)
    [(group, nums)] = plan_groups(len(frames), cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        ex._dispatch_payload(build_payload(frames, None, group, nums, cfg, 2))
    rec = profiling.trace_record()
    by_id = {s.id: s for s in rec.spans}
    ordered = sorted(rec.spans, key=lambda s: s.start_ns)
    kinds = ("timesformer.embed", "timesformer.time_attn", "timesformer.space_attn",
             "timesformer.mlp")
    nested = [(s.name, by_id[s.parent].name) for s in ordered if s.name in kinds]
    assert nested == [(kinds[0], "extract.rgb_net")] + [(k, "extract.rgb_net")
                                                        for k in kinds[1:]] * 2
    sdpa = [by_id[s.parent].name for s in ordered if s.name == "timesformer.sdpa"]
    assert sdpa == [kinds[1], kinds[2]] * 2
    assert rec.counters["timesformer.sdpa_calls"] == 4
    # no flow, and on the CPU no wait for the card
    assert not {"extract.flow", "extract.flow_net", "extract.inflight_wait"} & set(rec.totals())


def test_the_cli_writes_the_timesformer_tree(tmp_path, monkeypatch):
    monkeypatch.setenv("VIDEOQUERY_DEVICE", "cpu")
    video = decode.synthesize_video(str(tmp_path / "v.mp4"), n_frames=56, size=(88, 64))
    out = tmp_path / "feats"
    built = []

    def small_random(seed, splits, device, arch):
        built.append((splits, arch))
        member = tf.TimeSformer(tf.make_weights(seed, depth=1, dim=64, mlp_dim=128),
                                heads=SMALL_HEADS)
        return TwoStreamTSN(StreamEnsemble([member], splits, 3), None)

    monkeypatch.setattr(te.TwoStreamTSN, "random", staticmethod(small_random))
    te.main([video, "--out", str(out), "--arch", "timesformer", "--clip_time", "1",
             "--new_width", "88", "--new_height", "64", "--batch_clips", "1"])
    assert built == [((1,), "timesformer")]
    d = out / "v" / "Kinetics400_TimeSformer_split1"
    assert sorted(os.listdir(d)) == [f"{RGB}_global_pool_features.csv"]
    assert FLOW not in {csv.stream for _v, _s, csv in read_feature_tree(str(out))}
    # fps 25 by default: 55 usable frames are two 25-frame segments
    [(_video, _split, csv)] = read_feature_tree(str(out))
    assert list(csv.clip_numbers) == [1, 2]
    with pytest.raises(SystemExit):
        te.main([video, "--out", str(out), "--arch", "timesformer", "--weights", str(tmp_path)])
