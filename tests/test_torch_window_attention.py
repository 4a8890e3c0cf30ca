"""W1, Video Swin's window attention core
(``videoquery_torch/kernels/window_attention.py``).

On the CPU: the plain version on the model's ``bias_geometry`` against the
chain ``nn/video_swin.py`` ran before the kernel (its ``_bias``: the table
at ``relative_position_index[:N, :N]`` plus ``region_mask`` in float32,
rounded once, and one SDPA call with the fused backends and the math path
allowed), bit for bit in float32 and bfloat16; the kernel's arithmetic for
each position's table base and region id against the published geometry;
the argument checks.

On the card (marked ``cuda``; skip here): the kernel against the plain
version at the four published stages and at ragged windows, and a
forward's W1 launches, spans and counters, with no SDPA op, no pad and no
[*, 1, N, N] tensor. The module
imports no jax, so on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_window_attention.py
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils._python_dispatch import TorchDispatchMode

from videoquery_torch.kernels import window_attention as w1
from videoquery_torch.nn import video_swin as vs

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

PUBLISHED = vs.WINDOW                                   # (8, 7, 7)
SMALL = (2, 3, 3)                                       # tests/test_torch_videoswin.py's window
# (tokens, the published window): N = 392; 36, 96 and 294 (clamped);
# tests/test_torch_videoswin.py's stages (N = 18, 18, 8, and a padded 18)
CASES = {"n392": ((16, 14, 14), PUBLISHED), "n36": ((4, 3, 3), PUBLISHED),
         "n96": ((4, 4, 6), PUBLISHED), "n294": ((6, 9, 10), PUBLISHED),
         "small_4x12x12": ((4, 12, 12), SMALL), "small_4x3x3": ((4, 3, 3), SMALL),
         "small_4x2x2": ((4, 2, 2), SMALL), "small_3x12x16": ((3, 12, 16), SMALL)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def block(dims, table_window, shifted: bool):
    """(window, shift, windows) of a block on tokens ``dims``."""
    nominal = tuple(w // 2 for w in table_window) if shifted else (0, 0, 0)
    window, shift = vs.get_window_size(dims, table_window, nominal)
    windows = math.prod(-(-d // w) for d, w in zip(dims, window))
    return window, shift, windows


def operands(dims, table_window, shifted, heads, views, dtype, seed=0, device="cpu"):
    """qkv [views N windows, 3 heads 32] N(0, 1) in dtype and a float32 table
    N(0, 1) [rows, heads] (so the bias moves the softmax), and the block's
    geometry."""
    window, shift, windows = block(dims, table_window, shifted)
    g = torch.Generator(device=device).manual_seed(seed)
    rows = views * math.prod(window) * windows
    qkv = torch.randn(rows, 3 * heads * w1.HEAD_DIM, generator=g, device=device).to(dtype)
    table = torch.randn(w1.table_rows(table_window), heads, generator=g, device=device)
    return qkv, table, window, shift


def chain_before_the_kernel(qkv, table, views, dims, window, shift, table_window):
    """nn/video_swin.py's attention before W1: ``_bias``, then SDPA with the
    fused backends and the math path allowed."""
    n = math.prod(window)
    index = torch.from_numpy(vs.relative_position_index(table_window)[:n, :n].reshape(-1))
    rel = table[index].view(n, n, -1).permute(2, 0, 1)
    padded = [-(-d // ws) * ws for d, ws in zip(dims, window)]
    windows = math.prod(p // ws for p, ws in zip(padded, window))
    if any(shift):
        mask = torch.from_numpy(vs.region_mask(padded, window, shift)).to(rel)
        full = rel[None] + mask[:, None]
    else:
        full = rel[None].expand(windows, -1, -1, -1)
    bias = full.reshape(-1, 1, n, n).to(qkv.dtype).contiguous()
    heads, c = table.shape[1], qkv.shape[1] // 3
    q, k, v = qkv.view(views, n, windows * heads, 3, c // heads).permute(3, 2, 0, 1, 4).unbind(0)
    backends = [SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]
    with sdpa_kernel(backends):
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=(c // heads) ** -0.5)
    return o.permute(1, 2, 0, 3).reshape(-1, c)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plain_version_is_the_chain_before_the_kernel(case, shifted, dtype):
    dims, table_window = CASES[case]
    heads, views = 2, 2
    qkv, table, window, shift = operands(dims, table_window, shifted, heads, views,
                                         DTYPES[dtype], seed=len(case))
    got = w1.window_attention_reference(qkv, table, views,
                                        *vs.bias_geometry(dims, window, shift, table_window))
    want = chain_before_the_kernel(qkv, table, views, dims, window, shift, table_window)
    assert got.dtype == qkv.dtype and got.shape == (qkv.shape[0], qkv.shape[1] // 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dims", [(16, 56, 56), (16, 7, 7), (4, 3, 3), (3, 12, 16)])
def test_the_kernels_bases_and_region_ids_are_the_published_geometry(dims):
    """The kernel's arithmetic (csrc/window_attention.cu), written out: the
    table row of (i, j) is base[i] - base[j] + centre with base = d (2 wh -
    1)(2 ww - 1) + h (2 ww - 1) + w of position i in the published window,
    as ``relative_position_index(window)[:N, :N]``; two positions are
    masked where their region ids differ (per dim 0 before the last window,
    1 in it before the shift's cut, 2 after; id = 9 r_d + 3 r_h + r_w), as
    ``region_mask``: at the dims of
    tests/test_torch_videoswin.py::test_the_geometry_is_the_published_code,
    shifted and not."""
    table_window = PUBLISHED if dims[0] == 16 else SMALL
    wd, wh, ww = table_window
    stride_h, stride_d = 2 * ww - 1, (2 * wh - 1) * (2 * ww - 1)
    centre = (wd - 1) * stride_d + (wh - 1) * stride_h + ww - 1
    for shifted in (False, True):
        window, shift, windows = block(dims, table_window, shifted)
        n = math.prod(window)
        d, h, w = np.unravel_index(np.arange(n), table_window)
        base = d * stride_d + h * stride_h + w
        np.testing.assert_array_equal(base[:, None] - base[None, :] + centre,
                                      vs.relative_position_index(table_window)[:n, :n])
        padded = [-(-x // ws) * ws for x, ws in zip(dims, window)]
        counts = [p // ws for p, ws in zip(padded, window)]
        regions = []
        for size, s, count, p in zip(window, shift, counts, padded):
            at = np.arange(count)[:, None] * size + np.arange(size)[None, :]  # [windows, pos]
            r = np.where(at < p - size, 0, np.where(at < p - s, 1, 2))
            regions.append(r if s else np.zeros_like(r))
        rd, rh, rw = regions
        ids = (9 * rd[:, None, None, :, None, None] + 3 * rh[None, :, None, None, :, None]
               + rw[None, None, :, None, None, :]).reshape(windows, n)
        masked = np.where(ids[:, None, :] != ids[:, :, None], vs.MASK_VALUE, 0.0)
        np.testing.assert_array_equal(masked, vs.region_mask(padded, window, shift))


def _wrapper_call(qkv, table, dims=(4, 3, 3), table_window=PUBLISHED, views=1):
    window, shift, _windows = block(dims, table_window, False)
    return lambda: w1.window_attention(qkv, table, views, dims, window, shift, table_window)


def _checked(qkv, table, dims=(4, 3, 3), table_window=PUBLISHED, views=1):
    window, shift, _windows = block(dims, table_window, False)
    return lambda: w1._check(qkv, table, views, dims, window, shift, table_window)


def _kernel_check(heads, hd, dims, table_window):
    window, shift, windows = block(dims, table_window, False)
    qkv = torch.zeros(math.prod(window) * windows, 3 * heads * hd)
    table = torch.zeros(w1.table_rows(table_window), heads)
    return lambda: (w1._check(qkv, table, 1, dims, window, shift, table_window),
                    w1._check_kernel(qkv, table, window))


def _refusals():
    good, table = operands((4, 3, 3), PUBLISHED, False, 2, 1, torch.float32)[:2]
    return {
        "head dim 64": _kernel_check(2, 64, (4, 3, 3), PUBLISHED),
        "head dim 16": _kernel_check(2, 16, (4, 3, 3), PUBLISHED),
        "N of 448": _kernel_check(1, 32, (8, 7, 8), (8, 7, 8)),
        "float16 qkv": _checked(good.half(), table),
        "float64 qkv": _checked(good.double(), table),
        "a bfloat16 table": _checked(good, table.bfloat16()),
        "the table on another device": _checked(good, table.to("meta")),
        "qkv on another device": _wrapper_call(good.to("meta"), table.to("meta")),
        "qkv on the CPU": _wrapper_call(good, table),
        "a non-contiguous qkv": _checked(torch.zeros(good.shape[1], good.shape[0]).t(), table),
        "a table of another window": _checked(good, table[:-1]),
        "qkv of other rows": _checked(good[:-1], table),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_the_argument_checks_refuse(case):
    """Each refusal raises ValueError, before any launch: the operand
    checks and the kernel's own limits (head dim 32, N <= 392) on CPU
    operands, and the wrapper on a device that is not CUDA (the CPU takes
    the plain version)."""
    launches = w1.LAUNCHES
    with pytest.raises(ValueError):
        _refusals()[case]()
    assert w1.LAUNCHES == launches


def test_the_checks_pass_at_the_published_stages():
    for i, (heads, dims) in enumerate(zip(vs.HEADS, [(16, 56, 56), (16, 28, 28), (16, 14, 14),
                                                     (16, 7, 7)])):
        window, shift, windows = block(dims, PUBLISHED, True)
        qkv = torch.zeros(math.prod(window) * windows, 3 * vs.stage_dims()[i])
        table = torch.zeros(w1.table_rows(PUBLISHED), heads)
        w1._check(qkv, table, 1, dims, window, shift, PUBLISHED)
        w1._check_kernel(qkv, table, window)


# -- on the card ---------------------------------------------------------------

# the published stages' tokens and heads, at 32 x 224^2 views
STAGES = [((16, 56, 56), 4), ((16, 28, 28), 8), ((16, 14, 14), 16), ((16, 7, 7), 32)]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_operands(dims, heads, shifted, views, seed, table_window=PUBLISHED):
    qkv, table, window, shift = operands(dims, table_window, shifted, heads, views,
                                         torch.bfloat16, seed, "cuda")
    return qkv, table, window, shift


def exact_of_the_rounded(qkv, table, views, dims, window, shift, table_window=PUBLISHED):
    """The float32 attention of W1's own inputs: bf16 q, k and v, the table
    rounded to bf16 (W1's bias on every unmasked logit)."""
    return w1.window_attention_reference(qkv.float(), table.bfloat16().float(), views,
                                         *vs.bias_geometry(dims, window, shift, table_window))


# W1 against the float32 attention of its own bf16 inputs. Its error: p
# rounded to bf16 for the p v product (2^-9 of each weight), the output
# rounded to bf16 (2^-9 of it), ex2.approx (2 float32 ulps), and another
# order of the f32 sums. The masked logits carry bf16(B) - 100 where the
# stored mask held bf16(B - 100): both give p = 0 in f32. With v ~ N(0, 1)
# each output is a weighted mean of v: the p roundings move it by at most
# 2^-8 of the largest |v| of its window, the output's rounding by half a
# bf16 ulp, at most 2^-8 of itself (2^-10 on average). So: |W1 - exact| <=
# 2^-8 max|v| + 2^-8 |exact| elementwise, and the mean error under 2^-8 of
# the mean |exact|.
def assert_w1_close(got, want, qkv):
    vmax = qkv.view(qkv.shape[0], -1, 3, w1.HEAD_DIM)[:, :, 2].float().abs().max()
    err = (got.float() - want).abs()
    assert float((err - 2.0 ** -8 * (vmax + want.abs())).max()) <= 0, float(err.max())
    assert float(err.mean() / want.abs().mean()) < 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_w1_matches_plain_version_at_the_published_stages(stage, shifted):
    """Two views of each published stage in bf16 against the float32
    attention of W1's inputs, and the float32 route against the float32
    plain version (another order of sums)."""
    needs_card()
    dims, heads = STAGES[stage - 1]
    qkv, table, window, shift = card_operands(dims, heads, shifted, 2, seed=stage)
    want = exact_of_the_rounded(qkv, table, 2, dims, window, shift)
    launches = w1.LAUNCHES
    got = w1.window_attention(qkv, table, 2, dims, window, shift, PUBLISHED)
    f32 = w1.window_attention(qkv.float(), table, 2, dims, window, shift, PUBLISHED)
    torch.cuda.synchronize()
    assert w1.LAUNCHES == launches + 2
    assert_w1_close(got, want, qkv)
    torch.testing.assert_close(f32, w1.window_attention_reference(
        qkv.float(), table, 2, *vs.bias_geometry(dims, window, shift, PUBLISHED)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n36", "n96", "n294", "small_3x12x16"])
def test_w1_at_ragged_windows(case):
    """Windows of N not a multiple of 16 (36, 96 = 6 x 16, 294, 18),
    shifted where the dims allow, in bf16, and the float32 route against
    the float32 plain version at another order of sums."""
    needs_card()
    dims, table_window = CASES[case]
    qkv, table, window, shift = card_operands(dims, 3, True, 3, seed=len(case),
                                              table_window=table_window)
    want = exact_of_the_rounded(qkv, table, 3, dims, window, shift, table_window)
    assert_w1_close(w1.window_attention(qkv, table, 3, dims, window, shift, table_window),
                    want, qkv)
    f32 = w1.window_attention(qkv.float(), table, 3, dims, window, shift, table_window)
    torch.testing.assert_close(f32, w1.window_attention_reference(
        qkv.float(), table, 3, *vs.bias_geometry(dims, window, shift, table_window)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_w1_shifts_by_the_exact_maxima_where_the_bound_is_loose():
    """Logits of a spread past the bound's reach (q and k scaled by 12:
    C |q| |k| ~ 1,000 log2 units) take the pass of exact maxima and stay
    within the bound of the other tests."""
    needs_card()
    dims, heads = STAGES[3]
    qkv, table, window, shift = card_operands(dims, heads, True, 1, seed=9)
    qkv = qkv.view(qkv.shape[0], heads, 3, w1.HEAD_DIM)
    qkv[:, :, :2] *= 12
    qkv = qkv.view(qkv.shape[0], -1)
    want = exact_of_the_rounded(qkv, table, 1, dims, window, shift)
    got = w1.window_attention(qkv, table, 1, dims, window, shift, PUBLISHED)
    assert torch.isfinite(got).all()
    assert_w1_close(got, want, qkv)


@pytest.mark.cuda
def test_w1_refuses_what_it_does_not_take():
    needs_card()
    qkv, table, window, shift = card_operands((4, 3, 3), 2, False, 1, seed=0)
    odd = torch.empty(qkv.numel() + 1, dtype=qkv.dtype, device="cuda")[1:].view(qkv.shape)
    launches = w1.LAUNCHES
    with pytest.raises(ValueError):
        w1.window_attention(odd, table, 1, (4, 3, 3), window, shift, PUBLISHED)
    with pytest.raises(ValueError):
        w1.window_attention(qkv, table.cpu(), 1, (4, 3, 3), window, shift, PUBLISHED)
    assert w1.LAUNCHES == launches


class _Shapes(TorchDispatchMode):
    """Every aten op's name and its tensor outputs' shapes."""

    def __init__(self):
        super().__init__()
        self.ops, self.shapes = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append(str(func))
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(o, torch.Tensor):
                self.shapes.append(tuple(o.shape))
        return out


@pytest.mark.cuda
def test_a_forward_launches_w1_24_times_and_builds_no_mask(monkeypatch):
    """A bf16 forward of the published depths over 2 views of 32 x 224^2:
    24 attention calls, 12 under a shift mask, each one W1 launch (the
    wrapper's count and the counter) inside a videoswin.sdpa span with
    device events; no SDPA or softmax op, no pad and no tensor of shape
    [*, 1, N, N], the first forward's caches included; an input W1 does
    not take (float64) raises instead of falling to a plain path."""
    needs_card()
    from torch.profiler import ProfilerActivity, profile

    from videoquery_torch.core import profiling

    net = vs.VideoSwin(vs.make_weights(5)).cuda()
    x = torch.randn(2, 32, 224, 224, 3, device="cuda").bfloat16()
    launches = w1.LAUNCHES
    with _Shapes() as seen:                       # the first forward: the caches built too
        net.embed(x)
    torch.cuda.synchronize()
    assert w1.LAUNCHES == launches + 24
    assert not [op for op in seen.ops if "scaled_dot_product" in op or "softmax" in op
                or "constant_pad_nd" in op or op.startswith("aten.pad")]
    assert not [s for s in seen.shapes if len(s) >= 3 and s[-3] == 1 and s[-1] == s[-2] > 1]
    monkeypatch.setattr(profiling, "_state", profiling._State())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        net.embed(x)
    torch.cuda.synchronize()
    rec = profiling.trace_record()
    assert rec.counters == {"videoswin.views": 2, "videoswin.sdpa_calls": 24,
                            "videoswin.shifted_calls": 12, "videoswin.window_attn_launches": 24}
    sdpa = [sp for sp in rec.spans if sp.name == "videoswin.sdpa"]
    assert len(sdpa) == 24 and all(sp.device_ms is not None for sp in sdpa)
    with pytest.raises(ValueError):
        net.embed(x[:1, :16, :112, :112].double())
