"""The port's BN-Inception and TSN ensemble (videoquery_torch.nn) against the
JAX package.

The same random weights (the JAX package's init_params, carried across with
from_jax_params) and the same numpy inputs go through both, in float32.
Tolerance rtol 1e-4 / atol 1e-5: 69 convolutions whose sums run in another
order. Small inputs (64 px) keep the CPU time to seconds.

In bfloat16 (activations and weights in bf16, f32 sums) the two packages
round the same values at the same places but sum in another order, so a
bf16 activation may land one ulp apart and the difference carries through
69 convs: measured here, mean |port - JAX| / mean |JAX| ~0.5% for
global_pool and fc-action, about what bf16 is from f32. Held at 2% against
the JAX package in bf16 and at the JAX package's own criterion (< 10%,
tests/test_nn.py) against f32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoquery.nn import bn_inception as jb
from videoquery.nn import tsn as jtsn
from videoquery_torch.nn import bn_inception as tb
from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN, load_npz

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
BF16_VS_JAX, BF16_VS_F32 = 0.02, 0.1



def split_trees(stacked, k):
    return {s + 1: jax.tree.map(lambda a: np.asarray(a[s]), stacked) for s in range(k)}


@pytest.fixture(scope="module")
def jax_tsn():
    return jtsn.TwoStreamTSN.random(jax.random.PRNGKey(0), splits=(1, 2))


@pytest.mark.parametrize("seed,cin", [(0, 3), (5, 10)])
def test_init_params_same_seed_same_weights(seed, cin):
    want = jb.init_params(seed, cin)
    got = tb.init_params(seed, cin)
    assert set(got) == set(want)
    for name in want:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[name][k], np.asarray(want[name][k]))


@pytest.mark.parametrize("cin", [3, 10])
def test_bn_inception_matches_jax(cin):
    """global_pool and fc-action of one net, rgb and flow inputs."""
    params = jb.init_params(1, cin)
    x = np.random.default_rng(cin).normal(size=(2, 64, 64, cin)).astype(np.float32) * 30
    want = jb.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    net = tb.BNInception(params)
    got = net(torch.from_numpy(x))
    for key in ("global_pool", "fc-action"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL)
    assert got["global_pool"].shape == (2, 1024)


@pytest.mark.parametrize("mode", ["max", "ave"])
@pytest.mark.parametrize("size,k,s,pad", [(112, 3, 2, 0), (28, 3, 2, 0), (14, 3, 1, 1),
                                          (7, 3, 1, 1), (14, 3, 2, 0)])
def test_caffe_pooling_overhang_matches_jax(mode, size, k, s, pad):
    """Caffe's ceil-mode overhang (extra bottom/right padding) and AVE's
    constant k*k divisor; PyTorch's ceil_mode would shrink the divisor."""
    x = np.random.default_rng(size).normal(size=(2, size, size, 4)).astype(np.float32)
    jf = jb.max_pool if mode == "max" else jb.avg_pool
    tfn = tb.max_pool if mode == "max" else tb.avg_pool
    want = np.asarray(jf(jnp.asarray(x), k, s, pad))
    got = tfn(torch.from_numpy(x).permute(0, 3, 1, 2), k, s, pad).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert want.shape[1] == math.ceil((size + 2 * pad - k) / s) + 1 or pad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_avg_pool_overhang_differs_from_torch_ceil_mode():
    x = torch.ones((1, 1, 14, 14))     # 7 windows, the last one overhangs
    caffe = tb.avg_pool(x, 3, 2, 0)
    torch_ceil = torch.nn.functional.avg_pool2d(x, 3, 2, ceil_mode=True)
    assert caffe.shape == torch_ceil.shape
    assert float(caffe[0, 0, -1, -1]) == pytest.approx(4 / 9)   # padded zeros count
    assert float(torch_ceil[0, 0, -1, -1]) == pytest.approx(1.0)


def test_ensemble_and_clip_signature_match_jax(jax_tsn):
    """from_jax_params carries both streams' per-split weights across; the
    [K, B, 1024] ensemble embedding and the tick average match."""
    port = TwoStreamTSN.from_jax_params(split_trees(jax_tsn.rgb.stacked_params, 2),
                                        split_trees(jax_tsn.flow.stacked_params, 2),
                                        device="cpu")
    assert port.rgb.splits == (1, 2) and port.flow.in_channels == 10
    rng = np.random.default_rng(3)
    rgb = rng.normal(size=(1, 2, 64, 64, 3)).astype(np.float32) * 30
    flow = rng.normal(size=(1, 2, 64, 64, 10)).astype(np.float32) * 30
    want = jax_tsn.clip_signature(jnp.asarray(rgb), jnp.asarray(flow))
    got = port.clip_signature(torch.from_numpy(rgb), torch.from_numpy(flow))
    for key in ("rgb", "warped_optical_flow"):
        assert got[key].shape == (2, 1, 1024)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL)


def test_npz_bundles_load_without_jax(tmp_path):
    """convert_caffe npz bundles read with numpy alone give the same nets."""
    from videoquery.nn.convert_caffe import save_npz

    for stream, cin in (("rgb", 3), ("flow", 10)):
        save_npz(jb.init_params(7, cin), str(tmp_path / f"{stream}_split1.npz"))
    tree = load_npz(str(tmp_path / "rgb_split1.npz"))
    np.testing.assert_array_equal(tree["conv1/7x7_s2"]["w"],
                                  np.asarray(jb.init_params(7, 3)["conv1/7x7_s2"]["w"]))
    port = TwoStreamTSN.from_npz_dir(str(tmp_path), splits=(1,), device="cpu")
    ref = StreamEnsemble.from_jax_params({1: jb.init_params(7, 10)}, 10, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 64, 64, 10)).astype(np.float32))
    torch.testing.assert_close(port.flow.embed(x), ref.embed(x), rtol=0, atol=0)


def mean_rel(got, want) -> float:
    return float(np.abs(got - want).mean() / np.abs(want).mean())


@pytest.mark.parametrize("cin", [3, 10])
def test_bn_inception_bf16_matches_jax_bf16(cin):
    """global_pool and fc-action (f32) of the net run in bf16, against the
    JAX package's forward in bf16 and against the port's own f32 run."""
    params = jb.init_params(1, cin)
    x = np.random.default_rng(cin).normal(size=(2, 64, 64, cin)).astype(np.float32) * 30
    want = jb.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x, jnp.bfloat16))
    net = tb.BNInception(params)
    got = net(torch.from_numpy(x).to(torch.bfloat16))
    got32 = net(torch.from_numpy(x))
    for key in ("global_pool", "fc-action"):
        assert got[key].dtype == torch.float32
        assert mean_rel(got[key].numpy(), np.asarray(want[key], np.float32)) < BF16_VS_JAX
        assert mean_rel(got[key].numpy(), got32[key].numpy()) < BF16_VS_F32


def test_bf16_weights_are_cast_once():
    """The bf16 copies of the weights are made at the first bf16 forward
    and reused; the f32 path uses the parameters themselves."""
    net = tb.BNInception(jb.init_params(2, 3))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32))
    net(x)
    assert net._cast == {}
    net(x.to(torch.bfloat16))
    cast = net._cast[(torch.bfloat16, torch.device("cpu"))]
    w = cast["conv1__7x7_s2"]
    assert w.dtype == torch.bfloat16
    net(x.to(torch.bfloat16))
    assert net._cast[(torch.bfloat16, torch.device("cpu"))]["conv1__7x7_s2"] is w


def test_tsn_constructors_default_to_the_card(monkeypatch):
    """Without a device the constructors build on resolve_device(): CUDA
    (here, with no card, that raises) unless VIDEOQUERY_DEVICE names the CPU."""
    monkeypatch.delenv("VIDEOQUERY_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {1: jb.init_params(3, 3)}
    for build in (lambda: TwoStreamTSN.random(3, splits=(1,)),
                  lambda: StreamEnsemble.random(3, 3, splits=(1,)),
                  lambda: StreamEnsemble.from_jax_params(tree, 3),
                  lambda: TwoStreamTSN.from_jax_params(tree, {1: jb.init_params(4, 10)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    monkeypatch.setenv("VIDEOQUERY_DEVICE", "cpu")
    tsn = TwoStreamTSN.random(3, splits=(1,))
    assert tsn.rgb.nets[0].fc_w.device.type == "cpu"


def test_random_tsn_is_seeded():
    a = TwoStreamTSN.random(3, splits=(1,), device="cpu")
    b = TwoStreamTSN.random(3, splits=(1,), device="cpu")
    c = TwoStreamTSN.random(4, splits=(1,), device="cpu")
    wa, wb, wc = (t.rgb.nets[0].weights["conv1__7x7_s2"] for t in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
