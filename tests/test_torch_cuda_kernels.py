"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernels have no CPU or interpret mode). The module imports neither jax nor
the JAX package nor ``tools/``: its inputs come from numpy and the port, so
it runs on the machine with the card, where jax is not installed, without
the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(``chip_smoke.py`` runs exactly that as a phase of its own.) The plain
versions are held against the JAX package on the CPU by the other
``tests/test_torch_*.py`` modules.
"""

import contextlib
import re

import numpy as np
import pytest
import torch
from _torch_cases import block_params, make_pair, relu_input, texture
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from videoquery_torch.core import profiling
from videoquery_torch.core.profiling import trace_record
from videoquery_torch.kernels import _launch
from videoquery_torch.kernels import inception_block as t1
from videoquery_torch.kernels import query as k1
from videoquery_torch.kernels import roll as t2
from videoquery_torch.kernels import tvl1_flow
from videoquery_torch.kernels import tvl1_level as k2
from videoquery_torch.kernels import window_warp as k3
from videoquery_torch.kernels.tvl1 import TVL1Params
from videoquery_torch.nn import bn_inception as bi
from videoquery_torch.tools import conv_rounding
from videoquery_torch.tools.inception_block_bench import BF16_REL, BF16_SHARE, bf16_agreement
from videoquery_torch.tools.roll_repro import H as ROLL_H, W as ROLL_W

RTOL, ATOL = 1e-5, 1e-6   # only the order of sums differs (tests/test_pallas.py)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- K1 -----------------------------------------------------------------------

K1_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def k1_inputs(seed, q, s=2, k=3, n=256, d=128):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(s, k, n, d)).astype(np.float32)),
            torch.from_numpy(rng.random((s, k, n)) > 0.25),
            torch.from_numpy((rng.normal(size=(q, s, k, d)) * 0.05).astype(np.float32)),
            torch.from_numpy(rng.random((q, s, k)) > 0.1),
            torch.from_numpy(np.tile(np.asarray([1.0, 1.5], np.float32), (q, 1))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,target", [("f32", "f32"), ("bf16", "f32"), ("bf16", "bf16")])
def test_k1_matches_plain_version(dtype, target):
    """K1 on the card, a ragged N, both epilogues, each index type with each
    of its target types (bf16: the tensor-core body, one or three bf16 terms
    a target); query 0 bitwise equal alone and inside Q = 2, 3, 8 and 16."""
    needs_card()
    tdt = K1_DTYPES[target]
    f, m, t, tm, w = (a.cuda() for a in k1_inputs(5, 16))
    f = f.to(K1_DTYPES[dtype])
    f, m = f[:, :, :250].contiguous(), m[:, :, :250].contiguous()
    launches = k1.LAUNCHES
    avg, cnt = k1.query_k1(f, m, t, tm, target_dtype=tdt)
    sc = k1.query_k1(f, m, t, tm, w, target_dtype=tdt)
    assert k1.LAUNCHES == launches + 2
    avg_r, cnt_r = k1.query_k1_reference(f, m, t, tm, target_dtype=tdt)
    sc_r = k1.query_k1_reference(f, m, t, tm, w, target_dtype=tdt)
    assert torch.equal(cnt, cnt_r)
    torch.testing.assert_close(avg, avg_r, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(sc, sc_r, rtol=RTOL, atol=ATOL)
    a1, c1 = k1.query_k1(f, m, t[:1], tm[:1], target_dtype=tdt)
    s1 = k1.query_k1(f, m, t[:1], tm[:1], w[:1], target_dtype=tdt)
    for qb in (2, 3, 8, 16):
        ab, cb = k1.query_k1(f, m, t[:qb], tm[:qb], target_dtype=tdt)
        sb = k1.query_k1(f, m, t[:qb], tm[:qb], w[:qb], target_dtype=tdt)
        assert torch.equal(a1[0], ab[0]) and torch.equal(c1[0], cb[0]), qb
        assert torch.equal(s1[0], sb[0]), qb


# -- K2 -----------------------------------------------------------------------

K2_MODES = {
    "warped_separable": dict(grad_source="warped", separable_warp=True),
    "image_separable": dict(grad_source="image", separable_warp=True),
    "image_full": dict(grad_source="image", separable_warp=False),
}
# the device launches of K2's C call: its kernels and the tiles route's memset
K2_OWN = re.compile(k2.DEVICE_KERNELS.pattern + "|memset", re.IGNORECASE)


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


class _HostToDevice(TorchDispatchMode):
    """Records each host-to-device copy as (source pinned, non_blocking,
    bytes)."""

    def __init__(self):
        super().__init__()
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet is torch.ops.aten._to_copy:
            src, dst = args[0], kwargs.get("device")
            non_blocking = kwargs.get("non_blocking", False)
        elif packet is torch.ops.aten.copy_:
            dst, src = args[0].device, args[1]
            non_blocking = args[2] if len(args) > 2 else kwargs.get("non_blocking", False)
        else:
            src = dst = None
        if (src is not None and src.device.type == "cpu" and dst is not None
                and torch.device(dst).type == "cuda"):
            self.copies.append((src.is_pinned(), bool(non_blocking),
                                src.numel() * src.element_size()))
        return func(*args, **kwargs)


def aten_ops(fn) -> list[str]:
    """The aten ops one call of fn runs, in order (a C call is none)."""
    with _AtenOps() as mode:
        fn()
    return mode.ops


@pytest.mark.cuda
def test_k1s_span_reads_the_kernels_time(monkeypatch):
    """From an idle stream, with the profiler slowing the host, K1's span
    reads K1's own time and not the host's launch of the targets' split."""
    needs_card()
    monkeypatch.setattr(profiling, "_state", profiling._State())
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn(2, 3, 65_536, 1024, device=dev, generator=g).to(torch.bfloat16)
    mask = torch.ones(2, 3, 65_536, dtype=torch.bool, device=dev)
    targets = torch.randn(8, 2, 3, 1024, device=dev, generator=g)
    tmask = torch.ones(8, 2, 3, dtype=torch.bool, device=dev)
    k1.query_k1(feats, mask, targets, tmask, target_dtype=torch.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda.synchronize()          # the stream idle when the pass begins
            k1.query_k1(feats, mask, targets, tmask, target_dtype=torch.float32)
        torch.cuda.synchronize()
    span_ms = sorted(s.device_ms for s in trace_record().spans)[2]
    kernel_ms = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "query" in e.name)[2]
    # the events' and the profiler's clocks agree to a few %; the split's
    # launches under the profiler take the host tenths of a millisecond
    assert 0.95 * kernel_ms <= span_ms <= 1.05 * kernel_ms + 0.05, (span_ms, kernel_ms)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(30, 64, 3, 4), (20, 100, 3, 4), (8, 64, 3, 4),
                                   (64, 64, 3, 4), (128, 128, 6, 4), (128, 128, 12, 2),
                                   (256, 384, 6, 2)])
@pytest.mark.parametrize("mode", sorted(K2_MODES))
def test_k2_matches_plain_version(mode, shape):
    """K2 against its plain version on the card, bit for bit (the same
    operations in the same order, built without FMA contraction or fast
    math): a wrapping width with a ragged height, a ragged last band, a
    height below one band, bands in clusters of 4 and 8, the rescue window
    and a wide grid on the tiles route. One C call a level; one device
    launch on the band route. In mode 1 the band kernel needs a block
    barrier between the warp step and the primal half-step: the separable
    pass reads v up to d columns away, across warps, and the half-step
    overwrites it; a missing barrier need not show here, as it depends on
    how the warps are scheduled."""
    needs_card()
    h, w, d, n = shape
    p = TVL1Params(n_scales=1, n_warps=2, n_iters=8, **K2_MODES[mode])
    args = [torch.from_numpy(a).cuda() for a in make_pair(h, w, n=n, flow=d / 2)]
    launches = k2.LAUNCHES
    u, v = k2.tvl1_level(*args, p, d)
    assert k2.LAUNCHES == launches + 1
    ur, vr = k2.tvl1_level_reference(*args, p, d)
    assert torch.equal(u, ur) and torch.equal(v, vr)
    plan = k2.level_plan(n, h, w, d)
    want = plan.device_launches(k2.warp_mode(p), p.n_warps, p.n_iters)
    assert want == 1 or plan.route == "tiles"
    # the plan counts the C call's launches: K2's kernels by name and, on
    # the tiles route, the memset of its scratch. Besides the C call the
    # wrapper runs torch ops only in the image modes, where it takes I1's
    # gradients (no memset among them): its aten ops are theirs, the
    # allocations of the output and the tiles route's scratch and the
    # output's two views, and every other kernel the call launches is one
    # of theirs by name.
    call = lambda: k2.tvl1_level(*args, p, d)  # noqa: E731
    warped = k2.warp_mode(p) == k2.MODE_WARPED
    grads = ((lambda: None) if warped
             else lambda: [t.contiguous() for t in k2.centered_grad(args[1])])
    allocs = ["aten.empty"] * (2 if plan.route == "tiles" else 1)
    assert aten_ops(call) == aten_ops(grads) + allocs + ["aten.select"] * 2
    if warped:
        assert _launch.device_launches(call) == want
        return
    seen = _launch.device_kernels(call)
    assert sum(n for name, n in seen.items() if K2_OWN.search(name)) == want, seen
    other = {name for name in seen if not K2_OWN.search(name)}
    theirs = set(_launch.device_kernels(grads))
    assert other and other <= theirs, (other - theirs, theirs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 176, 6), (64, 88, 6), (32, 44, 3)])
@pytest.mark.parametrize("mode", ["warped_separable", "image_separable"])
def test_k2_on_the_flow_gate_grids(mode, shape):
    """K2 against its plain version, at most 1e-3 px of flow apart, on the
    flow-quality gate's grids: 128x176 (the full-resolution rows' finest
    level, the tiles route), 64x88 and 32x44 (the half-resolution rows, the
    band route); the production mode and the image mode of TVL1Params()'s
    rows."""
    needs_card()
    h, w, d = shape
    plan = k2.level_plan(4, h, w, d)
    assert plan.route == ("tiles" if w > 128 else "band")
    p = TVL1Params(n_scales=1, n_warps=2, n_iters=10, **K2_MODES[mode])
    args = [torch.from_numpy(a).cuda() for a in make_pair(h, w, seed=1, n=4, flow=d / 2)]
    launches = k2.LAUNCHES
    u, v = k2.tvl1_level(*args, p, d)
    assert k2.LAUNCHES == launches + 1
    ur, vr = k2.tvl1_level_reference(*args, p, d)
    assert float((u - ur).abs().max()) <= 1e-3 and float((v - vr).abs().max()) <= 1e-3
    assert torch.isfinite(u).all() and torch.isfinite(v).all()


# -- K3 -----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(30, 100), (30, 101)])
@pytest.mark.parametrize("separable", [True, False])
def test_k3_matches_plain_version(separable, hw):
    """K3 against its plain version on the card, rough flow beyond the clamp:
    a width that is a multiple of 4 (four pixels a thread, 16-byte loads and
    stores) and a ragged one (a pixel a thread), both with a ragged height;
    one launch per call."""
    needs_card()
    rng = np.random.default_rng(0)
    h, w = hw
    img = rng.random((5, h, w)).astype(np.float32)
    u = rng.uniform(-5, 5, (5, h, w)).astype(np.float32)
    v = rng.uniform(-5, 5, (5, h, w)).astype(np.float32)
    img, u, v = (torch.from_numpy(a).cuda() for a in (img, u, v))
    launches = k3.LAUNCHES
    got = k3.window_warp(img, u, v, 4, separable)
    assert k3.LAUNCHES == launches + 1
    want = k3.window_warp_reference(img, u, v, 4, separable)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,jumps", [(16, (-2, -1, 1, 2)), (24, (-3, -2, 2, 3))])
def test_k3_advects_a_warm_start(d, jumps):
    """K3 at the warm advection's windows (d=16 for groups of 5, d=24 for
    7) on advection-like fields: the image is a smooth flow of up to 8 px,
    the displacement -j times it for a signed frame distance j a pair, u and
    v stacked as extract._pair_flow_uv stacks them."""
    needs_card()
    rng = np.random.default_rng(2)
    n, h, w = 8, 64, 88
    u0 = (texture(rng, n, h, w) * 16 - 8).astype(np.float32)
    v0 = (texture(rng, n, h, w) * 16 - 8).astype(np.float32)
    j = np.resize(np.asarray(jumps, np.float32), n)[:, None, None]
    img = np.concatenate([u0, v0])
    du = np.concatenate([-j * u0] * 2)
    dv = np.concatenate([-j * v0] * 2)
    assert np.abs(du).max() > d - 4
    img, du, dv = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (img, du, dv))
    launches = k3.LAUNCHES
    got = k3.window_warp(img, du, dv, d)
    assert k3.LAUNCHES == launches + 1
    torch.testing.assert_close(got, k3.window_warp_reference(img, du, dv, d),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_k3_warps_an_affine_residual():
    """K3 at d=4 on the affine camera's residual field (the displacement of
    a zoom, rotation and pan less its integer value at the frame's centre),
    as tvl1_flow._affine_warp_rollwindow calls it, against its plain version;
    and the whole affine apply_camera on the card against the CPU's."""
    needs_card()
    rng = np.random.default_rng(3)
    n, h, w = 6, 128, 128
    img = torch.from_numpy(make_pair(h, w, seed=3, n=n)[0]).cuda()
    A = torch.from_numpy((rng.normal(size=(n, 2, 3)) * [0.02, 0.02, 9.0]).astype(np.float32))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    a = A[:, :, :, None, None]
    t = torch.round(torch.stack([a[:, 0, 0] * (w - 1) / 2 + a[:, 0, 1] * (h - 1) / 2 + a[:, 0, 2],
                                 a[:, 1, 0] * (w - 1) / 2 + a[:, 1, 1] * (h - 1) / 2 + a[:, 1, 2]],
                                1))
    du = (a[:, 0, 0] * xs + a[:, 0, 1] * ys + a[:, 0, 2] - t[:, 0]).contiguous().cuda()
    dv = (a[:, 1, 0] * xs + a[:, 1, 1] * ys + a[:, 1, 2] - t[:, 1]).contiguous().cuda()
    assert float(du.abs().max()) > 1.0
    launches = k3.LAUNCHES
    got = k3.window_warp(img, du, dv, 4)
    assert k3.LAUNCHES == launches + 1
    torch.testing.assert_close(got, k3.window_warp_reference(img, du, dv, 4),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tvl1_flow.apply_camera(img, A.cuda()).cpu(),
                               tvl1_flow.apply_camera(img.cpu(), A), rtol=RTOL, atol=ATOL)


# -- T1 -----------------------------------------------------------------------

T1_CASES = [("inception_3a", 256, 28), ("inception_5b", 1024, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_t1_matches_plain_version(dtype):
    """T1 against its plain version on the card at 3a's and 5b's shapes,
    3 members, 3 images; one C call per call, of at most 3 device launches
    in bf16 and 5 in f32. f32 within rtol 1e-4 / atol 1e-5 (only the order of sums
    differs); bf16 >= 99% of outputs within one ulp, max |diff| <= 1/64 of
    the largest output."""
    needs_card()
    for name, cin, hw in T1_CASES:
        spec = dict(bi.INCEPTION_BLOCKS)[name]
        wts = t1.block_weights(block_params(name, cin, members=3), name, spec, dtype, "cuda")
        x = torch.from_numpy(relu_input(hw, cin, 3)).cuda().to(dtype)
        launches = t1.LAUNCHES
        got = t1.fused_inception(wts, name, spec, x)
        assert t1.LAUNCHES == launches + 1
        want = t1.fused_inception_reference(wts, name, spec, x)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        else:
            share, rel = bf16_agreement(got, want)
            assert share >= BF16_SHARE and rel <= BF16_REL, (share, rel)
        # at most 3 device launches in bf16, 5 in f32 (a trace may miss one)
        n = _launch.device_launches(lambda: t1.fused_inception(wts, name, spec, x))
        assert 0 < n <= t1.DEVICE_LAUNCHES[dtype], n


@pytest.mark.cuda
def test_t1_on_the_path_geometry():
    """The extraction path's call: one member, x a channels-last activation
    of the port's bf16 net (the input of block 3a: the stem's output, 28x28
    x 192, here for 24 images), so its NHWC view is contiguous without a
    copy; T1 against its plain version by the bf16 criterion."""
    needs_card()
    net = bi.BNInception(bi.init_params(3, 3)).cuda()
    rng = np.random.default_rng(4)
    frames = torch.from_numpy((rng.normal(size=(24, 224, 224, 3)) * 50).astype(np.float32))
    with torch.no_grad():
        y = frames.cuda().to(torch.bfloat16).permute(0, 3, 1, 2)
        y = bi.max_pool(net._conv("conv1/7x7_s2", y), 3, 2, 0)
        y = net._conv("conv2/3x3", net._conv("conv2/3x3_reduce", y))
        y = bi.max_pool(y, 3, 2, 0)
    x = y.permute(0, 2, 3, 1)
    assert x.shape == (24, 28, 28, 192) and x.is_contiguous()
    spec = dict(bi.INCEPTION_BLOCKS)["inception_3a"]
    wts = net._block_weights("inception_3a", spec, x)
    got = t1.fused_inception(wts, "inception_3a", spec, x)
    want = t1.fused_inception_reference(wts, "inception_3a", spec, x)
    assert got.shape == want.shape == (24, 28, 28, 256)
    share, rel = bf16_agreement(got, want)
    assert share >= BF16_SHARE and rel <= BF16_REL, (share, rel)


@pytest.mark.cuda
def test_bf16_convs_round_once_on_the_card():
    """Every bf16 conv outside T1 (the stem's three, the stride-2 blocks'
    ten), widened to f32 under TF32 (a bf16 value is exact in TF32, so the
    products are exact and the sums f32 if cuDNN's algorithm for that shape
    forms them so), equals the same conv in full f32 then rounded once, on
    >= 99.9% of outputs, at the inputs a bf16 forward of 8 seeded 224x224
    frames gives it, with non-zero biases (tools/conv_rounding.py)."""
    needs_card()
    shares = conv_rounding.run(images=8, device="cuda", log=lambda _m: None)
    assert list(shares) == conv_rounding.convs_outside_t1() and len(shares) == 13
    low = {k: v for k, v in shares.items() if v < conv_rounding.BITWISE_SHARE}
    assert not low, low


# -- T2 -----------------------------------------------------------------------

@pytest.mark.cuda
def test_t2_matches_torch_roll():
    """T2 on the card with the shift in device memory, both axes and signs
    and a shift beyond the axis length; one launch per call."""
    needs_card()
    tile = np.random.default_rng(0).random((1, ROLL_H, ROLL_W)).astype(np.float32)
    x = torch.from_numpy(tile).repeat(3, 1, 1).cuda()
    for axis in (0, 1):
        for s in (-8, -1, 5, 300):
            launches = t2.LAUNCHES
            got = t2.roll(x, torch.tensor([s], dtype=torch.int32, device="cuda"), axis)
            assert t2.LAUNCHES == launches + 1
            assert torch.equal(got, torch.roll(x, s, axis + 1))


# -- the scale-out path: K1 on a shard, DDP training --------------------------

@pytest.mark.cuda
def test_sharded_search_on_a_nccl_world_of_one(tmp_path):
    """ShardedSearch on a NCCL world of one rank (K1 on the rank's shard, the
    all-gather, the merge) equals fused_query_topk: ids equal, values
    bitwise; K1 launched once."""
    needs_card()
    import torch.distributed as dist

    from videoquery_torch.core.meshes import initialize_multihost, make_mesh
    from videoquery_torch.index.store import FeatureIndex
    from videoquery_torch.search.distributed import ShardedSearch

    f, m, t, tm, w = (a.cuda() for a in k1_inputs(7, 5))
    f = f.to(torch.bfloat16)
    initialize_multihost(f"file://{tmp_path / 'store'}", 1, 0, "cuda:0")
    try:
        index = FeatureIndex(np.arange(100, 100 + f.shape[2]), f, m,
                             ("rgb", "warped_optical_flow"), (1, 2, 3), "global_pool")
        search = ShardedSearch(index, make_mesh("cuda"))
        launches = k1.LAUNCHES
        vals, ids = search.topk(t, tm, w, k=10)
        assert k1.LAUNCHES == launches + 1
    finally:
        dist.destroy_process_group()
    want_vals, want_pos = k1.fused_query_topk(f, m, t, tm, w, k=10)
    assert np.array_equal(ids, want_pos.cpu().numpy() + 100)
    assert np.array_equal(vals.view(np.uint32), want_vals.cpu().numpy().view(np.uint32))


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu():
    """One TSNTrainer step at 64x64 on the card equals the CPU's (loss rtol
    1e-5, weights rtol 2e-4 / atol 2e-6); the caller's TF32 flags come back
    after the step; a bf16 forward after the step (the card's optimizer
    updates the weights in place) uses the new weights."""
    needs_card()
    from videoquery_torch.train.trainer import TrainConfig, TSNTrainer

    cfg = TrainConfig(num_segments=2, num_classes=5, dropout_rate=0.0, learning_rate=0.01)
    params = bi.init_params(3, num_classes=5)
    rng = np.random.default_rng(4)
    frames = rng.normal(size=(2, 2, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(2,))
    card = TSNTrainer(params, cfg, device="cuda:0")
    x = torch.from_numpy(frames[:, 0]).to("cuda", torch.bfloat16)
    with torch.no_grad():
        before = card.module.embed(x)
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = card.step(frames, labels, seed=0)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    host = TSNTrainer(params, cfg, device="cpu")
    want = host.step(frames, labels, seed=0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    pc, ph = card.params(), host.params()
    for name in ph:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(pc[name][leaf], ph[name][leaf], rtol=2e-4, atol=2e-6)
    with torch.no_grad():
        after = card.module.embed(x)
        fresh = bi.BNInception(pc).to("cuda").embed(x)
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_extractor_on_a_nccl_world_of_one(tmp_path, dtype):
    """Extractor(mesh=make_mesh("cuda")) on a NCCL world of one rank equals
    the unsharded Extractor bit for bit on a small video (a 2-clip batch
    and a tail, warped flow on K3 and K2, 2 splits; T1 in bf16), launches
    K2 and K3 (and T1 in bf16), and runs the sharded code: NCCL
    all-gathers of the rescue's peaks, of the model shard's embeddings and
    of the data shard's signatures."""
    needs_card()
    import sys

    import torch.distributed as dist

    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.core.meshes import initialize_multihost, make_mesh
    from videoquery_torch.nn.tsn import TwoStreamTSN
    from videoquery_torch.pipeline import extract
    from videoquery_torch.pipeline.extract import Extractor, gather_signatures

    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (26, 96, 128, 3), np.uint8)
    cfg = ExtractionConfig(fps=5, clip_seconds=2, num_ticks=3, frame_resize=(128, 96),
                           crop_size=64, batch_clips=2, min_tail_seconds=1)
    tsn = TwoStreamTSN.random(0, (1, 2), "cuda:0")
    want = gather_signatures(list(Extractor(tsn, cfg, device="cuda:0", dtype=dtype)
                                  .extract_frames(frames)))
    initialize_multihost(f"file://{tmp_path / 'store'}", 1, 0, "cuda:0")
    try:
        ex = Extractor(tsn, cfg, device="cuda:0", dtype=dtype, mesh=make_mesh("cuda"))
        sites = set()
        gather = extract.all_gather_cat

        def spy(x, group, dim=0):
            assert x.is_cuda
            sites.add(sys._getframe(1).f_code.co_name)
            return gather(x, group, dim)

        k2.LAUNCHES = k3.LAUNCHES = t1.LAUNCHES = 0
        extract.all_gather_cat = spy
        try:
            got = gather_signatures(list(ex.extract_frames(frames)))
        finally:
            extract.all_gather_cat = gather
        launches = (k2.LAUNCHES, k3.LAUNCHES, t1.LAUNCHES)
    finally:
        dist.destroy_process_group()
    assert sites == {"_dispatch_payload", "ensemble_embed", "_rescue_fast_motion"}, sites
    assert [s.clip_numbers for s in got] == [s.clip_numbers for s in want] == [[1, 2], [3]]
    for g, w in zip(got, want):
        assert np.array_equal(g.rgb.view(np.uint32), w.rgb.view(np.uint32))
        assert np.array_equal(g.flow.view(np.uint32), w.flow.view(np.uint32))
    assert launches[0] > 0 and launches[1] > 0, launches
    assert (launches[2] > 0) == (dtype == "bfloat16"), launches


# -- the bench ----------------------------------------------------------------

@pytest.mark.cuda
def test_bench_query_mode_on_the_card():
    """The port's bench in query mode at 65,536 segments: its checks pass
    (each returned id's plain score, the k-th value of the plain top-k), K1
    launched once a timed call, and its line names the card, not a
    rehearsal."""
    needs_card()
    from videoquery_torch.tools import bench

    out = bench.run(["--mode", "query", "--segments", "65536", "--repeats", "3"])
    assert out["ok"] and all(out["checks"]["query"].values()), out["checks"]
    assert out["launches"]["query"]["K1"] == 3
    assert not out["rehearsal"] and out["device"]["count"] >= 1
    assert out["device"]["name"] == torch.cuda.get_device_name(0)
    assert out["metrics"]["query_p50_ms_batch16_65k_segments_n"] == 3


@pytest.mark.cuda
def test_k1_shards_merged_equal_the_unsharded_engine():
    """Four in-process row shards of a bf16 cone world (4,096 clips, D=128,
    4 queries), each scored by K1 and merged (``InProcessShards``): the
    unsharded engine's table bit for bit, counts equal, its revise and
    finalize band dicts equal (keys and f64 bits) and its optimizer's
    result; K1 launched once a shard."""
    needs_card()
    from videoquery_torch.core.config import HyperParams
    from videoquery_torch.search.engine import SearchEngine
    from videoquery_torch.testing.sharded_serving import (InProcessShards, band_rounds,
                                                          cone_world)

    world = cone_world(4096, 128, 4, device="cuda", dtype=torch.bfloat16, pad_multiple=64)
    engine = SearchEngine(world.index)
    tables = engine.compute_similarities_multi(world.targets)
    resident = engine.compute_similarities_multi(world.targets, resident=True)
    launches = k1.LAUNCHES
    shards = InProcessShards.from_index(world.index, world.targets, 4)
    assert k1.LAUNCHES == launches + 4
    hp = HyperParams()
    for qi, table in enumerate(tables):
        avg, counts = shards.table(qi)
        assert np.array_equal(avg.view(np.uint32), table.avg_sim.view(np.uint32))
        assert np.array_equal(counts, table.counts)
        revise, finalize, labels = band_rounds(world.index, table.avg_sim, table.counts,
                                               hp.default_weights, 200, 4)
        for spec in (revise, finalize):
            got = shards.round_scores(qi, **spec)
            assert got is not None and len(got) > 100
            assert got == resident[qi].round_scores(**spec)
        h_got, g_got = shards.optimize(qi, labels, hp)
        h_want, g_want = resident[qi].optimize(labels, hp)
        assert h_got == h_want
        assert np.array_equal(g_got.losses, g_want.losses)


# -- the extractor's dispatch ---------------------------------------------------

@contextlib.contextmanager
def one_host_wait(tsn):
    """Run the block under ``torch.cuda.set_sync_debug_mode("error")``: torch
    raises at every call that makes the host wait for the card. On torch
    2.11 (checked on an H100) that mode flags ``Event.synchronize``,
    ``Stream.synchronize``, ``.cpu()``, ``bool()`` or ``.item()`` of a CUDA
    tensor, a blocking host-to-device copy (pageable or pinned, and so
    ``torch.tensor(..., device="cuda")``), ``torch.linalg.solve`` (it reads
    its error code back), boolean-mask indexing and ``torch.nonzero``; it
    lets through non-blocking copies to and from pinned memory,
    ``pin_memory()``, ``Event.query``, ``topk`` and index gathers and
    scatters, and also ``torch.cuda.synchronize()``, which is therefore made
    to raise here by hand. ``torch.cuda.Event.synchronize``, the one wait
    allowed (the rescue's read-back), is let through and logged with the
    streams whose networks were queued before it. Yields that log."""
    from videoquery_torch.pipeline import extract

    waits, queued = [], []
    embed, event_sync, device_sync = (extract.ensemble_embed, torch.cuda.Event.synchronize,
                                      torch.cuda.synchronize)

    def spy_embed(stream, x, mesh=None):
        queued.append("rgb" if stream is tsn.rgb else "flow")
        return embed(stream, x, mesh)

    def allowed_wait(self):
        torch.cuda.set_sync_debug_mode("default")
        try:
            event_sync(self)
        finally:
            torch.cuda.set_sync_debug_mode("error")
        waits.append(tuple(queued))

    def refused(*_a, **_k):
        raise RuntimeError("torch.cuda.synchronize() inside an extraction batch")

    extract.ensemble_embed, torch.cuda.Event.synchronize = spy_embed, allowed_wait
    torch.cuda.synchronize = refused
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield waits
    finally:
        torch.cuda.set_sync_debug_mode("default")
        extract.ensemble_embed, torch.cuda.Event.synchronize = embed, event_sync
        torch.cuda.synchronize = device_sync


@pytest.fixture(scope="module")
def bench_batches():
    """The bench's extraction batches (8 clips x 150 frames at 256x340,
    textured and uniform noise, seed 0) as host arrays, and its seeded
    3-split TSN on the card."""
    needs_card()
    from videoquery_torch.nn.tsn import TwoStreamTSN
    from videoquery_torch.tools.bench import extraction_frames

    return ({kind: extraction_frames(kind, 8, 150, (256, 340), 2, 0)
             for kind in ("textured", "noise")},
            TwoStreamTSN.random(0, (1, 2, 3), "cuda:0"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_extract_step_waits_once_after_the_rgb_networks(bench_batches, dtype):
    """A bench batch (textured, then noise) through extract_step makes no
    host wait but the rescue's read-back, and that one only once the rgb
    stream's networks are queued; its signatures equal
    embed_step(prepare_step(...)) (the rescue decided at once) bit for bit,
    and K2, K3 and T1 launch as before the change: 5 / 11 / 48 a textured
    bf16 batch, 9 / 18 / 48 a noise one (T1 none in f32)."""
    needs_card()
    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.pipeline.extract import (PRODUCTION_TVL1, embed_step,
                                                   extract_step, prepare_step, step_plan)

    dev = torch.device("cuda:0")
    cfg = ExtractionConfig()
    batches, tsn = bench_batches
    plan = step_plan(150, cfg, "pallas", dev)
    for kind, k2_k3 in (("textured", (5, 11)), ("noise", (9, 18))):
        frames = torch.from_numpy(batches[kind]).to(dev)
        want = embed_step(tsn, *prepare_step(frames, plan, cfg, True, PRODUCTION_TVL1, dtype))
        torch.cuda.synchronize()
        k2.LAUNCHES = k3.LAUNCHES = t1.LAUNCHES = 0
        with one_host_wait(tsn) as waits:
            got = extract_step(tsn, frames, plan, cfg, True, PRODUCTION_TVL1, dtype)
        assert waits == [("rgb",)], (kind, waits)
        launches = (k2.LAUNCHES, k3.LAUNCHES, t1.LAUNCHES)
        assert launches == k2_k3 + ((48,) if dtype == "bfloat16" else (0,)), (kind, launches)
        for g, w in zip(got, want):
            assert g.shape == (3, 8, 1024) and bool(torch.isfinite(g).all())
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), kind


@pytest.fixture(scope="module")
def nccl_world_of_one(tmp_path_factory):
    """A NCCL world of one rank on the card and its (data, model) mesh, for
    this module's last tests."""
    needs_card()
    import torch.distributed as dist

    from videoquery_torch.core.meshes import initialize_multihost, make_mesh

    initialize_multihost(f"file://{tmp_path_factory.mktemp('nccl') / 'store'}", 1, 0,
                         "cuda:0")
    yield make_mesh("cuda")
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_dispatched_batch_uploads_once_and_waits_once(request, bench_batches, dtype, mesh):
    """Extractor._dispatch_payload on the textured bench batch (after one on
    the noise batch, so a copy that did not land shows), without and with a
    mesh (a NCCL world of one rank): one host wait, after the rgb networks
    are queued, and the signatures of embed_step(prepare_step(...)) on the
    same frames bit for bit. Without a mesh the batch's one host-to-device
    copy is the payload's, non-blocking from pinned memory (counted at the
    aten level: on the H100 a torch.profiler trace of a dispatch shows the
    upload's memcpy in a process's first traced dispatch and not in later
    ones, though the runtime call is there); the profiler (the most of 3
    traces) shows one copy into pinned memory, the rescue's choice, and no
    pageable copy."""
    needs_card()
    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.pipeline.extract import (PRODUCTION_TVL1, Extractor, embed_step,
                                                   prepare_step)
    from videoquery_torch.pipeline.payload import BatchPayload

    batches, tsn = bench_batches
    payload = BatchPayload(list(range(1, 9)), 150, batches["textured"], None, None)
    ex = Extractor(tsn, ExtractionConfig(), device="cuda:0", dtype=dtype,
                   mesh=request.getfixturevalue("nccl_world_of_one") if mesh else None)
    want = embed_step(tsn, *prepare_step(torch.from_numpy(payload.clip_rgb).cuda(),
                                         ex._plan(150), ex.cfg, True, PRODUCTION_TVL1, dtype))
    ex._dispatch_payload(BatchPayload(payload.nums, 150, batches["noise"], None, None))
    torch.cuda.synchronize()
    with one_host_wait(tsn) as waits:
        got = ex._dispatch_payload(payload)
    assert waits == [("rgb",)], waits
    assert got.clip_numbers == payload.nums
    for g, w in ((got.rgb, want[0]), (got.flow, want[1])):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    if not mesh:
        with _HostToDevice() as up:
            ex._dispatch_payload(payload)
        assert up.copies == [(True, True, payload.clip_rgb.nbytes)], up.copies
        copies = {name: n for name, n in _launch.device_kernels(
            lambda: ex._dispatch_payload(payload)).items() if "Memcpy" in name}
        assert copies.get("Memcpy DtoH (Device -> Pinned)") == 1, copies
        assert copies.get("Memcpy HtoD (Pinned -> Device)", 0) <= 1, copies
        assert not [name for name in copies if "Pageable" in name], copies


# -- I3D's convolutions and pools -----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("channels", [3, 2])
def test_i3d_on_the_card_against_the_reference(channels):
    """The card's route through I3D (the fused cuDNN conv + bias + ReLU, the
    space-to-depth stem, the NHWC pools) against the plain float32 reference
    on the card, with non-zero biases: float32 at rtol 1e-4 / atol 1e-5
    (another order of sums), bfloat16 under tests/test_torch_i3d.py's 2%
    mean-relative bound."""
    needs_card()
    from videoquery_torch.nn import i3d
    from videoquery_torch.testing import i3d_reference

    rng = np.random.default_rng(channels)
    params = i3d.init_params(5, channels)
    for leaf in params.values():
        leaf["b"] = (rng.normal(size=leaf["b"].shape) * 0.01).astype(np.float32)
    dev = torch.device("cuda", 0)
    net = i3d.InceptionI3d(params).to(dev)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 64, 64, channels)).astype(np.float32)).to(dev)
    want = i3d_reference.forward(params, x)
    got = net(x)
    for key in ("global_pool", "logits"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-5)
    low = net(x.bfloat16())["global_pool"]
    want = want["global_pool"]
    assert float((low - want).abs().mean() / want.abs().mean()) < 0.02

