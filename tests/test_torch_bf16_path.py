"""The bf16 network path of the port against the JAX package, with non-zero
biases (BN-folded weights have them; ``init_params`` draws zeros).

1. Each bf16 conv that stays on ``F.conv2d`` (the stem and the stride-2
   blocks) rounds once: ``relu(f32 sum of bf16 products + f32 bias)`` to
   bf16, as ``videoquery.nn.bn_inception._conv`` does. Held bit for bit on
   >= 99.9% of outputs (measured on the CPU: 100% for the 1x1 and the 7x7/s2
   stem, 99.994% for the 3x3, 99.989% for a stride-2 3x3; the rest one ulp
   apart where the sums run in another order). The parent's route (cuDNN's
   bf16 sum rounded, then the bias added and rounded again) agreed on
   85-86% of outputs in the same cases.
2. The whole net, rgb and flow, in bf16 against the JAX package in bf16:
   global_pool and fc-action within 2% (tests/test_torch_nn.py's criterion);
   measured 0.25-0.33% mean |diff| / mean |JAX|.
3. A stride-1 block in bf16 goes through T1 (``fused_inception``; on the CPU
   its plain version). Its conv branches are bit-equal to the JAX block's
   on >= 99.8% of outputs (measured 99.898-99.996%: where the chained 3x3
   convs' sums land one ulp apart in an intermediate, the next conv carries
   it on). The AVE pool branch
   differs: XLA's bf16 ``reduce_window`` rounds the window sum in bf16
   before /9, T1 sums in f32 and rounds once (70-76% bit-equal, 90-91%
   within one ulp, measured). So that branch is held bit-equal on >= 99.9%
   to the JAX package's own ``_conv`` applied to the pool summed in f32 and
   rounded once, and within 1/64 of the largest output to the JAX block.
4. A forward in bf16 calls ``fused_inception`` once per stride-1 block (8);
   one in f32 never.
5. ``tools/conv_rounding.py``, which holds each of the 13 convs outside T1
   against the f32 conv rounded once at the inputs a bf16 forward gives it
   (on the card, where cuDNN picks an algorithm per shape under TF32), runs
   here on the CPU at 64 px and finds each bit-equal on >= 99.9%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoquery.nn import bn_inception as jb
from videoquery_torch.kernels import inception_block as t1
from videoquery_torch.nn import bn_inception as tb
from videoquery_torch.tools import conv_rounding
from videoquery_torch.tools.inception_block_bench import with_biases

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

BITWISE_SHARE = 0.999
BLOCK_SHARE = 0.998
NET_VS_JAX = 0.02


def as_jax(params):
    return jax.tree.map(jnp.asarray, params)


def bf16_pair(x: np.ndarray):
    """The same bf16 values for JAX (NHWC) and for the port (torch NHWC)."""
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("name,k,pad,stride,hw", [
    ("conv2/3x3_reduce", 1, 0, 1, 28),
    ("conv2/3x3", 3, 1, 1, 28),
    ("conv1/7x7_s2", 7, 3, 2, 64),
    ("inception_4e/3x3", 3, 1, 2, 14),
])
def test_bf16_conv_rounds_once(name, k, pad, stride, hw):
    params = with_biases(tb.init_params(1, 3), 7)
    cin = params[name]["w"].shape[2]
    rng = np.random.default_rng(hw + k)
    x = (rng.normal(size=(2, hw, hw, cin)) * 30 if cin == 3
         else np.abs(rng.normal(size=(2, hw, hw, cin)))).astype(np.float32)
    xb, xt = bf16_pair(x)
    want = np.asarray(jb._conv(as_jax({name: params[name]}), name, xb, k, pad, stride)
                      .astype(jnp.float32))
    got = tb.BNInception(params)._conv(name, xt.permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    assert (got == want).mean() >= BITWISE_SHARE, (got == want).mean()


def mean_rel(got, want) -> float:
    return float(np.abs(got - want).mean() / np.abs(want).mean())


@pytest.mark.parametrize("cin", [3, 10])
def test_bf16_net_with_biases_matches_jax(cin):
    params = with_biases(tb.init_params(1, cin), cin)
    x = np.random.default_rng(cin).normal(size=(2, 64, 64, cin)).astype(np.float32) * 30
    want = jb.forward(as_jax(params), jnp.asarray(x, jnp.bfloat16))
    got = tb.BNInception(params)(torch.from_numpy(x).to(torch.bfloat16))
    for key in ("global_pool", "fc-action"):
        assert mean_rel(got[key].numpy(), np.asarray(want[key], np.float32)) < NET_VS_JAX


@pytest.mark.parametrize("name,hw,cin", [("inception_3a", 28, 192),
                                         ("inception_4d", 14, 608),
                                         ("inception_5b", 7, 1024)])
def test_bf16_block_route_matches_jax_block(name, hw, cin):
    spec = dict(jb.INCEPTION_BLOCKS)[name]
    params = with_biases(tb.init_params(1, 3), 5)
    x = np.maximum(np.random.default_rng(1).normal(size=(3, hw, hw, cin)) * 0.5, 0)
    xb, xt = bf16_pair(x.astype(np.float32))
    jp = as_jax(params)
    want = np.asarray(jb._inception(jp, name, spec, xb).astype(jnp.float32))
    got = tb.BNInception(params)._inception(name, spec, xt.permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    c = spec["c1"] + spec["c3"] + spec["d2"]
    assert got.shape == want.shape and got.shape[-1] == c + spec["pp"]
    assert (got[..., :c] == want[..., :c]).mean() >= BLOCK_SHARE
    # the pool branch: JAX's pool projection on the pool summed in f32
    if spec["pool"] == "ave":
        pool = jb.avg_pool(xb.astype(jnp.float32), 3, 1, 1).astype(jnp.bfloat16)
    else:
        pool = jb.max_pool(xb, 3, 1, 1)
    pp = np.asarray(jb._conv(jp, f"{name}/pool_proj", pool, 1, 0, 1).astype(jnp.float32))
    assert (got[..., c:] == pp).mean() >= BITWISE_SHARE
    assert np.abs(got - want).max() <= np.abs(want).max() / 64


def test_bf16_forward_runs_every_stride1_block_through_t1(monkeypatch):
    calls = []
    fused = t1.fused_inception

    def spy(params, name, spec, x):
        calls.append((name, x.dtype, x.is_contiguous()))
        return fused(params, name, spec, x)

    monkeypatch.setattr(t1, "fused_inception", spy)
    net = tb.BNInception(tb.init_params(2, 3))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 32, 32, 3))
                         .astype(np.float32) * 30)
    net(x)
    assert calls == []
    net(x.to(torch.bfloat16))
    stride1 = [n for n, b in tb.INCEPTION_BLOCKS if b["stride"] == 1]
    assert [c[0] for c in calls] == stride1 and len(calls) == 8
    # channels-last activations: each block's NHWC view is contiguous, also
    # for an input that is not (the stem's widened copy is channels-last)
    strided = x.to(torch.bfloat16).repeat(1, 1, 2, 1)[:, :, ::2]
    assert not strided.is_contiguous()
    net(strided)
    assert len(calls) == 16
    assert all(dt == torch.bfloat16 and contiguous for _, dt, contiguous in calls)


def test_conv_rounding_tool_checks_every_conv_outside_t1():
    names = conv_rounding.convs_outside_t1()
    assert names[:3] == ["conv1/7x7_s2", "conv2/3x3_reduce", "conv2/3x3"] and len(names) == 13
    assert {n.split("/")[0] for n in names[3:]} == {"inception_3c", "inception_4e"}
    seen = []
    shares = conv_rounding.run(images=2, size=64, device="cpu", log=seen.append)
    assert list(shares) == names and len(seen) == 13
    assert min(shares.values()) >= conv_rounding.BITWISE_SHARE, shares
