"""S1, I3D's stem conv (``videoquery_torch/kernels/stem_conv3d.py``), on the
CPU: its plain version against the plain reference's ``unit3d``
at stride 2 (``videoquery_torch/testing/i3d_reference.py``) for rgb and
flow, float32 and bfloat16, at odd and even sizes (SAME pads unevenly);
the packed weight's layout and round trip; every check the kernel's
wrapper makes; the shared-memory plan; and the conv's span and launch
counter in a CPU forward. The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``).

- float32: rtol 1e-4 / atol 1e-5, as ``tests/test_torch_i3d.py`` (the two
  sum the same products in float32; padding and layout differ).
- bfloat16: every output within one bf16 ulp of the reference's float32
  value on the same bf16 inputs and weights (the plain version rounds its
  float32 sum once).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videoquery_torch.core import profiling
from videoquery_torch.kernels import stem_conv3d as s1
from videoquery_torch.nn import i3d
from videoquery_torch.testing import i3d_reference as ref

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
SIZES = [(9, 33, 31), (8, 32, 32), (7, 16, 17), (4, 14, 14)]


def case(c: int, size: tuple, seed: int, n: int = 1):
    """x [n, c, T, H, W] channels-last-3d in [-1, 1), an OIDHW weight of
    I3D's stem scale and a non-zero float32 bias."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((n, c) + size, generator=g) * 2 - 1).contiguous(
        memory_format=torch.channels_last_3d)
    w = torch.randn(s1.COUT, c, 7, 7, 7, generator=g) * 0.05
    b = torch.randn(s1.COUT, generator=g) * 0.1
    return x, w, b


def reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``unit3d`` at stride 2 in float32 on x's and w's values."""
    params = {"c": {"w": w.float().permute(2, 3, 4, 1, 0).numpy(), "b": b.numpy()}}
    return ref.unit3d(params, "c", x.float(), (2, 2, 2))


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of v (8 bits of precision)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126))) - 7)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("c", s1.CHANNELS)
def test_plain_version_matches_the_reference_in_f32(c, size):
    x, w, b = case(c, size, seed=sum(size) + c, n=2)
    got = s1.stem_conv_reference(x, w, b)
    want = reference(x, w, b)
    assert got.shape == want.shape == (2, 64) + tuple(-(-n // 2) for n in size)
    assert got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("c", s1.CHANNELS)
def test_plain_version_rounds_once_in_bf16(c, size):
    x, w, b = case(c, size, seed=sum(size) + 10 * c)
    x, w = x.bfloat16(), w.bfloat16()
    got = s1.stem_conv_reference(x, w, b)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    want = reference(x, w, b)
    assert ((got.float() - want).abs() <= bf16_ulp(want)).all()
    assert torch.equal(got, s1.stem_conv_f32(x, w, b).bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", s1.CHANNELS)
def test_the_packed_weight_round_trips(c, dtype):
    _x, w, _b = case(c, (1, 1, 1), seed=c)
    w = w.to(dtype)
    packed = s1.pack_weight(w)
    steps = s1.k16_steps(c)
    assert packed.shape == (7, steps, 8, 2, 8, 8) and packed.dtype == dtype
    assert torch.equal(s1.unpack_weight(packed, c), w)
    # every tap once in each kt's K; the padding is zero
    live = [i for i in s1._k_index(c) if i < 49 * c]
    assert sorted(live) == list(range(49 * c))
    assert int((packed == 0).sum()) == 7 * 64 * (16 * steps - 49 * c)
    # K position 16 s + 8 g + e of kt is tap (kh, kw, c) of its window
    rng = np.random.default_rng(c)
    for _ in range(50):
        kt, s, ng, g, r, e = (int(rng.integers(n)) for n in packed.shape)
        kh, cell = divmod(16 * s + 8 * g + e, s1.window(c))
        want = w[8 * ng + r, cell % c, kt, kh, cell // c] if kh < 7 and cell < 7 * c else 0
        assert packed[kt, s, ng, g, r, e] == want


def test_the_k_order_pads_each_row_to_an_even_count():
    assert [s1.window(c) for c in s1.CHANNELS] == [22, 16]
    assert [s1.k16_steps(c) for c in s1.CHANNELS] == [10, 7]
    # products over the taps': 160 / 147 rgb, 112 / 98 flow
    assert [16 * s1.k16_steps(c) / (49 * c) for c in s1.CHANNELS] == pytest.approx(
        [160 / 147, 112 / 98])


def test_the_plan_at_the_cells_frames():
    rgb, flow = s1.plan(224, 224, 3), s1.plan(224, 224, 2)
    # 17 staged rows a step (a tile of 512 positions touches 6 output rows)
    assert (rgb.stage_rows, rgb.stages, rgb.rs) == (17, 3, 1392)
    assert (flow.stage_rows, flow.stages, flow.rs) == (17, 3, 928)
    assert rgb.smem == 7 * 10 * 2048 + 256 + 48 + 3 * 17 * 1392 <= s1.MAX_SMEM
    assert flow.smem == 7 * 7 * 2048 + 256 + 48 + 3 * 17 * 928
    for h, w, c in ((224, 224, 3), (63, 65, 2), (64, 64, 3), (15, 8, 3), (1, 2, 2)):
        p = s1.plan(h, w, c)
        # a staged row spans every window and the frame row after its lead
        assert p.rs % 16 == 0 and p.rs >= 2 * (s1.LEAD + w * c)
        assert p.stage_rows <= 2 * -(-h // 2) + 5
    # wide frames fall back to 2 stages, then are refused
    assert s1.plan(224, 512, 3).stages == 2
    with pytest.raises(ValueError):
        s1.plan(224, 2048, 3)


def kernel_case(c=3, w=32):
    x = torch.zeros(1, 4, 6, w, c, dtype=torch.bfloat16).permute(0, 4, 1, 2, 3)
    packed = s1.pack_weight(torch.zeros(64, c, 7, 7, 7, dtype=torch.bfloat16))
    return x, packed, torch.zeros(64)


def test_the_kernels_checks_pass_on_what_it_takes():
    for c, w in ((3, 32), (2, 33), (3, 224)):
        x, packed, b = kernel_case(c, w)
        assert s1.check_kernel_operands(x, packed, b) == s1.plan(6, w, c)


def _misaligned(x):
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:]
    return flat.view(1, 4, 6, x.shape[-1], x.shape[1]).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("bad", [
    "float32", "ncdhw", "channels", "rank", "odd_rgb_width", "misaligned", "packed_shape",
    "packed_dtype", "packed_strides", "bias_dtype", "bias_shape", "too_wide"])
def test_the_kernels_checks_refuse(bad):
    x, packed, b = kernel_case()
    if bad == "float32":
        x, packed = x.float(), packed.float()
    elif bad == "ncdhw":
        x = x.contiguous()
    elif bad == "channels":
        x = torch.zeros(1, 4, 4, 6, 32, dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)
    elif bad == "rank":
        x = x[0]
    elif bad == "odd_rgb_width":
        x, _p, _b = kernel_case(3, 33)
    elif bad == "misaligned":
        x = _misaligned(x)
    elif bad == "packed_shape":
        packed = s1.pack_weight(torch.zeros(64, 2, 7, 7, 7, dtype=torch.bfloat16))
    elif bad == "packed_dtype":
        packed = packed.float()
    elif bad == "packed_strides":
        packed = packed.transpose(0, 1)
    elif bad == "bias_dtype":
        b = b.bfloat16()
    elif bad == "bias_shape":
        b = torch.zeros(32)
    elif bad == "too_wide":
        x, packed, b = kernel_case(3, 2048)
    with pytest.raises(ValueError):
        s1.check_kernel_operands(x, packed, b)


def test_the_wrapper_refuses_the_cpu_and_bad_weights():
    """stem_conv launches the kernel or raises: a CPU tensor, even one the
    kernel would take on the card, is refused (the CPU takes
    stem_conv_reference); pack_weight takes only the stem's weight."""
    x, packed, b = kernel_case()
    assert s1.check_kernel_operands(x, packed, b)
    launches = s1.LAUNCHES
    with pytest.raises(ValueError, match="stem_conv_reference"):
        s1.stem_conv(x, packed, b)
    assert s1.LAUNCHES == launches
    for w in (torch.zeros(32, 3, 7, 7, 7), torch.zeros(64, 4, 7, 7, 7),
              torch.zeros(64, 3, 7, 7, 5)):
        with pytest.raises(ValueError):
            s1.pack_weight(w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_cpu_forward_takes_the_plain_stem_once(dtype, monkeypatch):
    """Each forward runs its stem conv once through the plain version with
    the OIDHW weight and the float32 bias, inside an i3d.stem_conv span
    inside i3d.stem; the CPU launches no kernel."""
    net = i3d.InceptionI3d(i3d.init_params(4, 2))
    x = (torch.rand(1, 8, 32, 32, 2) * 2 - 1).to(dtype)
    calls, real = [], s1.stem_conv_reference

    def spy(v, w, b):
        calls.append((tuple(v.shape), v.dtype, tuple(w.shape), w.dtype, b.dtype))
        return real(v, w, b)

    monkeypatch.setattr(s1, "stem_conv_reference", spy)
    monkeypatch.setattr(profiling, "_state", profiling._State())
    with profile(activities=[ProfilerActivity.CPU]):
        net.embed(x)
    assert calls == [((1, 2, 8, 32, 32), dtype, (64, 2, 7, 7, 7), dtype, torch.float32)]
    rec = profiling.trace_record()
    by_id = {s.id: s for s in rec.spans}
    convs = [s for s in rec.spans if s.name == "i3d.stem_conv"]
    assert len(convs) == 1 and by_id[convs[0].parent].name == "i3d.stem"
    assert rec.counters["i3d.stem_conv_launches"] == 0
