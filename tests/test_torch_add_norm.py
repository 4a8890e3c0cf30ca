"""N1, TimeSformer's residual add and next LayerNorm in one pass
(``videoquery_torch/kernels/add_norm.py``), on the CPU: the wrapper's plain
version in its three layouts against the op chain ``nn/timesformer.py``
ran before the kernel (``add_`` through views, ``mean``, ``torch.cat``,
``F.layer_norm``), bit for bit in float32 and bfloat16; the layouts row by
row, as the kernel computes each row's place; the argument checks; the
``timesformer.add_norm`` spans and the launch counter in a CPU forward;
and the CPU forward's signature against that op chain, bit for bit. The
kernel itself runs only on the card (``tests/test_torch_cuda_kernels.py``).
"""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from videoquery_torch.core import profiling
from videoquery_torch.kernels import add_norm as n1
from videoquery_torch.nn import timesformer as tf

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

# B segments of T frames of N patch sites, width D
B, N, T, D = 2, 3, 4, 64
EPS = tf.LN_EPS
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the rows of the step output each layout adds
DELTA_ROWS = {"time": B * N * T, "space": B * T * (1 + N), "mlp": B * (1 + N * T)}


def operands(after: str, dtype, seed: int = 0):
    """x [B, 1 + N T, D], the step's output, and a LayerNorm's non-trivial
    weight and bias, in dtype."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, 1 + N * T, D, generator=g).to(dtype)
    delta = torch.randn(DELTA_ROWS[after], D, generator=g).to(dtype)
    weight = (1 + 0.1 * torch.randn(D, generator=g)).to(dtype)
    bias = (0.1 * torch.randn(D, generator=g)).to(dtype)
    return x, delta, weight, bias


def unfused_chain(x, delta, weight, bias, after: str):
    """The add and the next LayerNorm as nn/timesformer.py ran them before
    N1: the end of one step and the start of the next."""
    b, tokens, d = x.shape
    n, t = (tokens - 1) // T, T
    if after == "time":
        xp = x[:, 1:]
        if delta is not None:
            xp.add_(delta.view(b, -1, d))
        frames = torch.cat([x[:, :1, None].expand(b, t, 1, d),
                            x[:, 1:].view(b, n, t, d).transpose(1, 2)], dim=2)
        return F.layer_norm(frames, (d,), weight, bias, EPS)
    if after == "space":
        r = delta.view(b, t, 1 + n, d)
        x[:, 0].add_(r[:, :, 0].mean(dim=1))
        x[:, 1:].view(b, n, t, d).add_(r[:, :, 1:].transpose(1, 2))
        return F.layer_norm(x, (d,), weight, bias, EPS)
    x.add_(delta.view_as(x))
    return F.layer_norm(x[:, 1:], (d,), weight, bias, EPS)


CASES = [("time", True), ("time", False), ("space", True), ("mlp", True)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("after, with_delta", CASES)
def test_the_plain_version_equals_the_unfused_chain_bit_for_bit(after, with_delta, dtype):
    x, delta, weight, bias = operands(after, DTYPES[dtype], seed=len(after))
    delta = delta if with_delta else None
    want_x = x.clone()
    want = unfused_chain(want_x, delta, weight, bias, after)
    before = n1.LAUNCHES
    got = n1.add_norm(x, delta, weight, bias, T, after, EPS)
    assert n1.LAUNCHES == before
    assert got.dtype == x.dtype and got.shape == want.shape and got.is_contiguous()
    assert torch.equal(x, want_x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("after", ["time", "space", "mlp"])
def test_each_layout_row_by_row(after):
    """Where each row comes from and goes to, as the kernel computes it
    from (b, n, t): x's patch row (b, 1 + n T + t), delta's row and z's
    row, in float64 (no rounding to hide a wrong place)."""
    x, delta, weight, bias = operands(after, torch.float64, seed=7)
    old = x.clone()
    z = n1.add_norm_reference(x, delta, weight, bias, T, after, EPS).reshape(-1, D)

    def ln(row):
        return F.layer_norm(row, (D,), weight, bias, EPS)

    for b in range(B):
        cls = b * (1 + N * T)
        if after == "space":
            mean = delta.view(B, T, 1 + N, D)[b, :, 0].mean(dim=0)
            torch.testing.assert_close(x[b, 0], old[b, 0] + mean, rtol=0, atol=1e-12)
            torch.testing.assert_close(z[cls], ln(x[b, 0]), rtol=0, atol=1e-12)
        for n in range(N):
            for t in range(T):
                p = 1 + n * T + t
                src = {"time": (b * N + n) * T + t, "space": (b * T + t) * (1 + N) + 1 + n,
                       "mlp": cls + p}[after]
                dst = {"time": (b * T + t) * (1 + N) + 1 + n, "space": cls + p,
                       "mlp": b * N * T + p - 1}[after]
                assert torch.equal(x[b, p], old[b, p] + delta[src])
                torch.testing.assert_close(z[dst], ln(x[b, p]), rtol=0, atol=1e-12)
        if after == "time":
            for t in range(T):
                assert torch.equal(z[(b * T + t) * (1 + N)], ln(x[b, 0]))
    assert z.shape[0] == {"time": B * T * (1 + N), "space": B * (1 + N * T),
                          "mlp": B * N * T}[after]


BAD = ["float16", "int", "weight_dtype", "delta_device", "rank2", "tokens", "delta_rows",
       "weight_size", "x_strided", "delta_strided", "width_f32", "width_bf16", "after",
       "no_delta"]


@pytest.mark.parametrize("bad", BAD)
def test_the_argument_checks_raise(bad):
    after = "space"
    x, delta, weight, bias = operands(after, torch.float32)
    if bad == "float16":
        x, delta, weight, bias = x.half(), delta.half(), weight.half(), bias.half()
    elif bad == "int":
        x = x.to(torch.int32)
    elif bad == "weight_dtype":
        weight = weight.bfloat16()
    elif bad == "delta_device":
        delta = delta.to("meta")
    elif bad == "rank2":
        x = x.reshape(-1, D)
    elif bad == "tokens":
        x = x[:, :-1].contiguous()
    elif bad == "delta_rows":
        delta = delta[:-1]
    elif bad == "weight_size":
        weight = weight[:-8]
    elif bad == "x_strided":
        x = torch.cat([x, x], dim=2)[..., ::2]
    elif bad == "delta_strided":
        delta = delta.t().contiguous().t()
    elif bad in ("width_f32", "width_bf16"):
        dtype, d = (torch.float32, 6) if bad == "width_f32" else (torch.bfloat16, 12)
        x, delta = x[..., :d].to(dtype).contiguous(), delta[:, :d].to(dtype).contiguous()
        weight, bias = weight[:d].to(dtype), bias[:d].to(dtype)
    elif bad == "after":
        after = "embed"
    else:
        delta = None
    before, snapshot = n1.LAUNCHES, x.clone()
    with pytest.raises(ValueError):
        n1.add_norm(x, delta, weight, bias, T, after, EPS)
    assert n1.LAUNCHES == before
    assert torch.equal(x, snapshot) or bad == "int"


SMALL = dict(depth=3, dim=64, mlp_dim=128, frames=T, crop=32)


def unfused_forward(net, x):
    """The CPU forward as nn/timesformer.py ran it before N1: each step's
    LayerNorm, attention and residual add in its own span-free body."""
    w = net._weights(x)
    t = x.shape[1]
    tokens = net._embed_tokens(w, x)
    b, s, d = tokens.shape
    n = (s - 1) // t
    for i in range(net.depth):
        xp = tokens[:, 1:]
        z = net._norm(w, f"blocks/{i}/temporal_norm1", xp)
        a = net._attention(w, f"blocks/{i}/temporal_attn", z.view(-1, t, d))
        xp.add_(net._linear(w, f"blocks/{i}/temporal_fc", a).view(b, -1, d))
        frames = torch.cat([tokens[:, :1, None].expand(b, t, 1, d),
                            tokens[:, 1:].view(b, n, t, d).transpose(1, 2)], dim=2)
        z = net._norm(w, f"blocks/{i}/norm1", frames)
        r = net._attention(w, f"blocks/{i}/attn", z.view(b * t, 1 + n, d)).view(b, t, 1 + n, d)
        tokens[:, 0].add_(r[:, :, 0].mean(dim=1))
        tokens[:, 1:].view(b, n, t, d).add_(r[:, :, 1:].transpose(1, 2))
        z = net._norm(w, f"blocks/{i}/norm2", tokens)
        h = F.gelu(net._linear(w, f"blocks/{i}/mlp/fc1", z))
        tokens.add_(net._linear(w, f"blocks/{i}/mlp/fc2", h).view_as(tokens))
    return net._norm(w, "norm", tokens[:, 0]).float()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_cpu_signature_is_the_unfused_chains_bit_for_bit(dtype):
    net = tf.TimeSformer(tf.make_weights(11, **SMALL), heads=4)
    g = torch.Generator().manual_seed(12)
    x = torch.randn((B, T, 32, 32, 3), generator=g).to(DTYPES[dtype])
    with torch.no_grad():
        want = unfused_forward(net, x)
    assert torch.equal(net.embed(x), want)


def test_a_cpu_trace_spans_each_n1_call_in_the_step_it_opens(monkeypatch):
    """3 x depth - 1 timesformer.add_norm spans: in block 0's space and MLP
    steps, then in every step of the later blocks; no device events on the
    CPU, and no launch."""
    monkeypatch.setattr(profiling, "_state", profiling._State())
    net = tf.TimeSformer(tf.make_weights(13, **SMALL), heads=4)
    x = torch.randn(1, T, 32, 32, 3)
    before = n1.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]):
        net.embed(x)
    rec = profiling.trace_record()
    by_id = {s.id: s for s in rec.spans}
    calls = [s for s in sorted(rec.spans, key=lambda s: s.start_ns)
             if s.name == "timesformer.add_norm"]
    steps = ("timesformer.time_attn", "timesformer.space_attn", "timesformer.mlp")
    assert len(calls) == 3 * SMALL["depth"] - 1
    assert [by_id[s.parent].name for s in calls] == list(steps[1:]) + list(steps) * (
        SMALL["depth"] - 1)
    # each call opens its step: nothing of the step is traced before it
    for s in calls:
        parent = by_id[s.parent]
        assert not [c for c in rec.spans if c.parent == parent.id and c.start_ns < s.start_ns]
    assert all(s.device_ms is None for s in calls)
    assert rec.counters["timesformer.add_norm_launches"] == 0
    assert n1.LAUNCHES == before
