"""The port's compact uploads and streaming decode against the JAX package.

Host side (numpy + cv2, both packages): the uint8 gray at the flow grid,
the host resize+crop, YUV 4:2:0, every payload layout of build_payload (an
array or a streaming window with a freed prefix) and stream_payloads
(including a container that under-reports its frame count) are bit-equal.
Device side: ``_yuv420_to_bgr`` within 1e-4 of the JAX function and within
2 LSB of cv2's own I420 decoder; ``preprocess_rgb(precropped=True)`` equal
to JAX's; ``Extractor.extract_video_stream`` with host gray, host crop and
YUV 4:2:0 against the JAX package's on the same mp4 (its pair path,
``flow_impl="pallas"``, in interpret mode; same weights via
``from_jax_params``) at rtol 1e-4 / atol 1e-5, the tolerance of the
port's other extraction tests. The port-only checks keep the floors of the
JAX package's tests (tests/test_pipeline.py): rgb exact and flow cosine >
0.97 for host gray against the device gray, host crop at the target size
bit-identical to host gray, rgb cosine > 0.999 for YUV 4:2:0.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videoquery.core.config import ExtractionConfig as JaxExtractionConfig
from videoquery.kernels.tvl1 import TVL1Params as JaxTVL1Params
from videoquery.nn.tsn import TwoStreamTSN as JaxTSN
from videoquery.pipeline import decode as jdecode
from videoquery.pipeline import extract as je
from videoquery.pipeline import payload as jpayload
from videoquery.pipeline import preprocess as jpre
from videoquery_torch.core.config import ExtractionConfig
from videoquery_torch.kernels.tvl1 import TVL1Params
from videoquery_torch.nn.tsn import TwoStreamTSN
from videoquery_torch.pipeline import decode, payload, preprocess
from videoquery_torch.pipeline import extract as te

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

# the small geometry of tests/test_torch_extract.py: 10-frame clips, 3
# ticks, 96x64 frames (the target size: host crop is pure slicing), 64 px
# crops, a 32x48 flow grid
CFG = dict(fps=5, clip_seconds=2, num_ticks=3, frame_resize=(96, 64), crop_size=64,
           batch_clips=2, min_tail_seconds=1, decode_at_target=False)
LAYOUTS = {"full": {}, "gray": dict(host_gray=True),
           "crop": dict(host_gray=True, host_crop=True),
           "yuv": dict(host_gray=True, host_crop=True, host_yuv420=True)}
SMALL_TVL1 = dict(n_scales=2, n_warps=1, n_iters=4, camera_model="homography")


def cfgs(layout, **extra):
    """(port config, JAX config) of one upload layout."""
    kw = {**CFG, **LAYOUTS[layout], **extra}
    return ExtractionConfig(**kw), JaxExtractionConfig(**kw)


def textured_frames(n, h, w, seed):
    """BGR uint8 [n, h, w, 3]: a blurred texture under a pan."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 255, (h * 2, w * 2, 3), np.uint8), (9, 9), 3)
    return np.stack([np.ascontiguousarray(base[i:i + h, 2 * i:2 * i + w]) for i in range(n)])


def assert_payloads_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.nums == w.nums and g.f_len == w.f_len and g.native_hw == w.native_hw
        assert g.clip_rgb.dtype == w.clip_rgb.dtype == np.uint8
        np.testing.assert_array_equal(g.clip_rgb, w.clip_rgb)
        if w.gray is None:
            assert g.gray is None
        else:
            np.testing.assert_array_equal(g.gray, w.gray)


@pytest.mark.parametrize("hw,grid", [((256, 340), (128, 128)), ((64, 96), (32, 48)),
                                     ((255, 339), (100, 120)), ((120, 160), (120, 160))])
def test_host_helpers_equal_jax(hw, grid):
    """gray_flow_grid (each interp), resize_crop_frames (at and off the
    target size, both crops) and bgr_to_yuv420: the same bytes."""
    frames = textured_frames(3, *hw, seed=hw[0])
    for interp in ("area2", "area", "linear"):
        np.testing.assert_array_equal(decode.gray_flow_grid(frames, *grid, interp=interp),
                                      jdecode.gray_flow_grid(frames, *grid, interp=interp))
    for resize_wh, crop in (((hw[1], hw[0]), 48), ((340, 256), 224), ((96, 64), 64)):
        for where in ("center", "tl"):
            np.testing.assert_array_equal(
                decode.resize_crop_frames(frames, resize_wh, crop, where),
                jdecode.resize_crop_frames(frames, resize_wh, crop, where))
    even = frames[:, :hw[0] // 2 * 2, :hw[1] // 2 * 2]
    np.testing.assert_array_equal(decode.bgr_to_yuv420(even), jdecode.bgr_to_yuv420(even))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_build_payload_layouts_equal_jax(layout):
    """Every upload layout, from an array and from a streaming window whose
    consumed prefix is freed (None), with and without producer gray: the
    same payload bytes as the JAX package's build_payload."""
    cfg, jcfg = cfgs(layout)
    frames = textured_frames(26, 64, 96, seed=1)
    grid = payload.flow_grid_shape(64, 96, 2)
    grays = list(decode.gray_flow_grid(frames, *grid))
    for group, nums in payload.plan_groups(len(frames), cfg):
        want = jpayload.build_payload(frames, None, group, nums, jcfg, 2)
        assert_payloads_equal([payload.build_payload(frames, None, group, nums, cfg, 2)],
                              [want])
        start = group[0][0] - 1
        window = [None] * start + list(frames[start:])
        gwin = [None] * start + grays[start:]
        assert_payloads_equal(
            [payload.build_payload(window, gwin, group, nums, cfg, 2)],
            [jpayload.build_payload(window, gwin, group, nums, jcfg, 2)])
        if cfg.host_gray:   # producer gray equals the per-clip gray
            assert_payloads_equal(
                [payload.build_payload(window, gwin, group, nums, cfg, 2)], [want])
    if layout == "yuv":
        assert want.clip_rgb.shape == (1, 3, 96, 64)       # the tail alone
        assert want.gray.shape == (1, 10, 32, 48) and want.native_hw == (64, 96)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 36-frame mp4 at 96x64: 35 decoded frames, 3 full 10-frame clips and
    a 5-frame tail."""
    path = str(tmp_path_factory.mktemp("compact") / "v.mp4")
    decode.synthesize_video(path, n_frames=36, size=(96, 64), fps=5)
    return path


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("reported", [None, 16])
def test_stream_payloads_equal_jax(video, layout, reported, monkeypatch):
    """stream_payloads in both packages yields the same payloads; with a
    container that under-reports its count (16: one full clip streamed, the
    rest replanned from the decoded count) every clip still comes exactly
    once, and the replanned batches read a window whose streamed prefix is
    freed."""
    cfg, jcfg = cfgs(layout)
    if reported is not None:
        monkeypatch.setattr(decode, "probe_frame_count", lambda p: reported)
        monkeypatch.setattr(jdecode, "probe_frame_count", lambda p: reported)
    seen = []
    build = payload.build_payload

    def spy(frames, gray, group, nums, cfg_, div):
        seen.append(sum(f is None for f in frames))
        return build(frames, gray, group, nums, cfg_, div)

    monkeypatch.setattr(payload, "build_payload", spy)
    got = list(payload.stream_payloads(video, cfg, 2, None))
    want = list(jpayload.stream_payloads(video, jcfg, 2, None))
    assert_payloads_equal(got, want)
    assert sorted(n for p in got for n in p.nums) == [1, 2, 3, 4]
    assert seen[0] == 0 and seen[-1] > 0      # the window frees what it streamed
    if reported is not None:
        assert [p.nums for p in got] == [[1], [2, 3], [4]]


def test_yuv420_to_bgr_matches_jax_and_cv2():
    """The device inverse of bgr_to_yuv420: within 1e-4 of the JAX function
    and within 2 LSB of cv2.cvtColor(COLOR_YUV2BGR_I420) on random frames
    (the hardest case for the constants), also with leading batch axes."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (6, 64, 48, 3), np.uint8)
    yuv = decode.bgr_to_yuv420(frames)
    assert yuv.shape == (6, 96, 48)
    got = te._yuv420_to_bgr(torch.from_numpy(yuv)).numpy()
    want = np.asarray(je._yuv420_to_bgr(jnp.asarray(yuv)))
    assert got.dtype == np.float32 and got.shape == (6, 64, 48, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    ref = np.stack([cv2.cvtColor(y, cv2.COLOR_YUV2BGR_I420) for y in yuv])
    assert np.abs(got - ref.astype(np.float32)).max() <= 2.0
    batched = te._yuv420_to_bgr(torch.from_numpy(yuv.reshape(2, 3, 96, 48))).numpy()
    np.testing.assert_array_equal(batched.reshape(got.shape), got)


def test_preprocess_precropped_matches_jax():
    """precropped=True: only the mean subtraction, for uint8 tick frames and
    the float frames the YUV path rebuilds."""
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, (2, 3, 64, 64, 3), np.uint8)
    f32 = (u8.astype(np.float32) + rng.random(u8.shape, np.float32)).astype(np.float32)
    for x in (u8, f32):
        got = preprocess.preprocess_rgb(torch.from_numpy(x), (96, 64), 64, precropped=True)
        want = jpre.preprocess_rgb(jnp.asarray(x), (96, 64), 64, precropped=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        bf = preprocess.preprocess_rgb(torch.from_numpy(x), (96, 64), 64,
                                       dtype=torch.bfloat16, precropped=True)
        assert bf.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def tsns():
    """(JAX TSN, the port's with the same weights), one split."""
    jtsn = JaxTSN.random(jax.random.PRNGKey(0), splits=(1,))
    unstack = lambda st: {1: jax.tree.map(lambda a: np.asarray(a[0]), st)}  # noqa: E731
    return jtsn, TwoStreamTSN.from_jax_params(unstack(jtsn.rgb.stacked_params),
                                              unstack(jtsn.flow.stacked_params),
                                              device="cpu")


def flat(sigs):
    return {n: (s.rgb[:, i], s.flow[:, i]) for s in sigs for i, n in enumerate(s.clip_numbers)}


@pytest.fixture(scope="module")
def short_video(tmp_path_factory):
    """A 26-frame mp4 at 96x64: 2 full clips (one batch) and a 5-frame
    tail."""
    path = str(tmp_path_factory.mktemp("compact") / "short.mp4")
    decode.synthesize_video(path, n_frames=26, size=(96, 64), fps=5)
    return path


def test_extract_video_stream_compact_matches_jax(short_video, tsns, monkeypatch):
    """extract_video_stream with host gray, host crop and YUV 4:2:0 in both
    packages, on the same mp4 and weights: the same clips in order, the
    signatures of both streams within rtol 1e-4 / atol 1e-5.

    The two TV-L1 solvers sum in another order (and XLA fuses the JAX one
    differently inside and outside the extraction step), so a few quantized
    flow bytes differ by one LSB; at these small random nets one such byte
    inside the crop moves a flow signature by up to ~5e-5. So the JAX run
    takes the port's quantized flow of each batch (its ``_pair_flow``
    swapped), which holds everything of the compact path but the solver,
    and the solver is held on the compact gray on its own: >= 99.9% of the
    quantized bytes equal, none more than 1 apart, as in
    tests/test_torch_extract.py."""
    jtsn, ptsn = tsns
    cfg, jcfg = cfgs("yuv")
    pex = te.Extractor(ptsn, cfg, warped=True, tvl1=TVL1Params(**SMALL_TVL1),
                       device="cpu")
    flows = []
    real = te._pair_flow

    def record(*args):
        flows.append(real(*args))
        return flows[-1]

    monkeypatch.setattr(te, "_pair_flow", record)
    got = pex.extract_video_stream(short_video)
    assert [s.clip_numbers for s in got] == [[1, 2], [3]]

    jex = je.Extractor(jtsn, jcfg, warped=True, flow_impl="pallas",
                       tvl1=JaxTVL1Params(**SMALL_TVL1))
    fed = iter(flows)   # one trace a batch: the two batches differ in shape
    monkeypatch.setattr(je, "_pair_flow", lambda *a, **k: jnp.asarray(next(fed).numpy()))
    je._extract_step.clear_cache()
    try:
        want = jex.extract_video_stream(short_video)
    finally:
        je._extract_step.clear_cache()   # drop the traces of the swapped flow
    monkeypatch.undo()
    assert [s.clip_numbers for s in want] == [[1, 2], [3]]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.rgb, np.asarray(b.rgb), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a.flow, np.asarray(b.flow), rtol=1e-4, atol=1e-5)

    pair_flow = jax.jit(je._pair_flow, static_argnames=(
        "bound", "warped", "tvl1", "value_scale", "warm_camera"))
    payloads = list(payload.stream_payloads(short_video, cfg, 2, None))
    assert len(payloads) == len(flows)
    for pl, port_q in zip(payloads, flows):
        _t, _ti, _st, pair_dev, warm = jex._plan_arrays(pl.f_len)
        fh, fw = pl.gray.shape[2:]
        with pltpu.force_tpu_interpret_mode():
            jax_q = np.asarray(pair_flow(
                jnp.asarray(pl.gray, jnp.float32) / 255.0, pair_dev, bound=20.0,
                warped=True, tvl1=jex.tvl1,
                value_scale=(pl.native_hw[1] / fw, pl.native_hw[0] / fh),
                warm_plan=warm, warm_camera="init"))
        diff = np.abs(port_q.numpy().astype(int) - jax_q.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


@pytest.fixture(scope="module")
def port_runs(video, tsns):
    """The port's signatures of the mp4 in each layout, from the whole
    decoded video (extract_frames) and from the stream."""
    _jtsn, ptsn = tsns
    frames = decode.load_video(video)
    out = {}
    for layout in LAYOUTS:
        ex = te.Extractor(ptsn, cfgs(layout)[0], warped=True,
                          tvl1=TVL1Params(**SMALL_TVL1), device="cpu")
        out[layout] = (flat(te.gather_signatures(list(ex.extract_frames(frames)))),
                       flat(ex.extract_video_stream(video)))
    return out


def cosine(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def test_stream_equals_whole_video_in_each_layout(port_runs):
    """Streaming and the whole decoded video give the same payloads, so the
    same signatures bit for bit."""
    for layout, (whole, stream) in port_runs.items():
        assert sorted(whole) == sorted(stream) == [1, 2, 3, 4], layout
        for n in whole:
            np.testing.assert_array_equal(stream[n][0], whole[n][0])
            np.testing.assert_array_equal(stream[n][1], whole[n][1])


def test_compact_layouts_keep_the_jax_floors(port_runs):
    """Against the full-frame upload: host gray keeps rgb exact and the flow
    direction (cosine > 0.97); host crop at the target size is bit-identical
    to host gray; YUV 4:2:0 keeps flow exact and rgb cosine > 0.999."""
    full, gray, crop, yuv = (port_runs[k][0] for k in ("full", "gray", "crop", "yuv"))
    for n in full:
        np.testing.assert_allclose(gray[n][0], full[n][0], atol=1e-5)
        assert cosine(gray[n][1], full[n][1]) > 0.97
        np.testing.assert_array_equal(crop[n][0], gray[n][0])
        np.testing.assert_array_equal(crop[n][1], gray[n][1])
        np.testing.assert_array_equal(yuv[n][1], crop[n][1])
        assert cosine(yuv[n][0], crop[n][0]) > 0.999


def test_extract_step_needs_native_hw_for_cropped_ticks(tsns):
    _jtsn, ptsn = tsns
    cfg, _ = cfgs("crop")
    ex = te.Extractor(ptsn, cfg, warped=True, tvl1=TVL1Params(**SMALL_TVL1), device="cpu")
    ticks = torch.zeros((1, 3, 64, 64, 3), dtype=torch.uint8)
    gray = torch.zeros((1, 10, 32, 48), dtype=torch.uint8)
    with pytest.raises(ValueError, match="native_hw"):
        te.extract_step(ptsn, ticks, ex._plan(10), cfg, True, ex.tvl1, gray_u8=gray)


def test_stream_decode_error_is_raised(video, tsns, monkeypatch):
    """A decode failure after the first streamed batch reaches the caller;
    the video is never cut short silently."""
    _jtsn, ptsn = tsns
    real = decode.video_frames

    def failing(p, new_size=None, skip_first=True):
        for i, f in enumerate(real(p, new_size, skip_first)):
            if i >= 22:
                raise RuntimeError("mid-video decode failure")
            yield f

    monkeypatch.setattr(decode, "video_frames", failing)
    ex = te.Extractor(ptsn, dataclasses.replace(cfgs("yuv")[0], stream_window_batches=2),
                      warped=True, tvl1=TVL1Params(**SMALL_TVL1), device="cpu")
    with pytest.raises(RuntimeError, match="mid-video"):
        ex.extract_video_stream(video)
