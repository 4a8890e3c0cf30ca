"""The port's caffemodel converter (videoquery_torch.nn.convert_caffe) against
the JAX package's, on the synthetic caffemodels of tests/test_nn.py (the
modern LayerParameter layout and the legacy V1 one).

Both readers give the same blobs; both converters the same BN-folded
parameters, bit for bit; ``save_npz`` the same file bytes (numpy stamps
each zip member with the clock, so both saves run under one frozen clock);
the CLI (``python -m videoquery_torch.nn.convert_caffe``) the same bundle,
which the port's TSN loads and runs.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_nn import _layer, _layer_v1, _len_field
from videoquery.nn import bn_inception as jbn
from videoquery.nn import convert_caffe as jconvert
from videoquery_torch.nn import bn_inception, convert_caffe, tsn
from videoquery_torch.nn.bn_inception import BNInception

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synthetic_caffemodel(path, rng, in_channels=3, layout="v2", bn=True):
    """A caffemodel of the whole architecture: every conv (with its frozen
    BN unless bn=False) and fc-action; blobs in OIHW, as Caffe stores
    them."""
    raw = _len_field(1, b"net") if layout == "v1" else b""
    for name, (kh, kw, cin, cout) in bn_inception.conv_shapes(in_channels).items():
        w = rng.normal(size=(cout, cin, kh, kw)).astype(np.float32) * 0.05
        b = rng.normal(size=(cout,)).astype(np.float32) * 0.01
        stats = [rng.uniform(0.5, 1.5, cout).astype(np.float32),
                 rng.normal(size=cout).astype(np.float32) * 0.01,
                 rng.normal(size=cout).astype(np.float32) * 0.01,
                 rng.uniform(0.5, 1.5, cout).astype(np.float32)]
        if layout == "v1":
            raw += _layer_v1(name, 4, [w, b]) + (_layer_v1(name + "_bn", 0, stats) if bn else b"")
        else:
            raw += _layer(name, "Convolution", [w, b]) + (
                _layer(name + "_bn", "BN", stats) if bn else b"")
    fc = [rng.normal(size=(101, 1024)).astype(np.float32) * 0.01, np.zeros(101, np.float32)]
    raw += _layer_v1("fc-action", 14, fc) if layout == "v1" else _layer("fc-action",
                                                                        "InnerProduct", fc)
    with open(path, "wb") as f:
        f.write(raw)
    return str(path)


def assert_params_equal(got, want):
    assert list(got) == list(want)
    for layer in want:
        assert list(got[layer]) == list(want[layer])
        for k in want[layer]:
            assert got[layer][k].dtype == want[layer][k].dtype
            np.testing.assert_array_equal(got[layer][k], want[layer][k])


def test_conv_shapes_and_fold_bn_equal_jax(rng):
    for cin in (3, 10):
        assert bn_inception.conv_shapes(cin) == jbn.conv_shapes(cin)
    args = [rng.normal(size=(3, 3, 4, 8)).astype(np.float32), rng.normal(size=8).astype(np.float32),
            rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(size=8).astype(np.float32),
            rng.normal(size=8).astype(np.float32), rng.uniform(0.5, 1.5, 8).astype(np.float32)]
    for got, want in zip(bn_inception.fold_bn(*args), jbn.fold_bn(*args)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["v1", "v2"])
def test_readers_agree(tmp_path, rng, layout):
    """read_caffemodel of a small net in each layout: the same layers and
    blobs as the JAX reader (legacy dims 1-padded to 4-d, as there)."""
    w = rng.normal(size=(8, 4, 3, 3)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    fc = rng.normal(size=(101, 1024)).astype(np.float32)
    if layout == "v1":
        raw = (_len_field(1, b"net") + _layer_v1("conv1/7x7_s2", 4, [w, b])
               + _layer_v1("fc-action", 14, [fc, np.zeros(101, np.float32)]))
    else:
        raw = _layer("conv1/7x7_s2", "Convolution", [w, b])
    path = tmp_path / "net.caffemodel"
    path.write_bytes(raw)
    got, want = convert_caffe.read_caffemodel(str(path)), jconvert.read_caffemodel(str(path))
    assert list(got) == list(want)
    for name in want:
        for a, c in zip(got[name], want[name]):
            assert a.shape == c.shape
            np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(got["conv1/7x7_s2"][0].reshape(8, 4, 3, 3), w)


@pytest.mark.parametrize("layout", ["v1", "v2"])
@pytest.mark.parametrize("in_channels", [3, 10])
def test_convert_full_net_equals_jax(tmp_path, rng, layout, in_channels):
    """The whole net, with BN: the port's convert gives the JAX converter's
    parameters bit for bit; conv1 is fold_bn of the transposed blobs; the
    converted net runs in the port."""
    path = synthetic_caffemodel(tmp_path / "m.caffemodel", rng, in_channels, layout)
    params = convert_caffe.convert(path, in_channels=in_channels)
    assert_params_equal(params, jconvert.convert(path, in_channels=in_channels))
    layers = convert_caffe.read_caffemodel(path)
    w, b = layers["conv1/7x7_s2"]
    stats = [x.reshape(-1) for x in layers["conv1/7x7_s2_bn"]]
    wf, bf = bn_inception.fold_bn(w.reshape(64, in_channels, 7, 7).transpose(2, 3, 1, 0),
                                  b.reshape(64), *stats)
    np.testing.assert_array_equal(params["conv1/7x7_s2"]["w"], wf)
    np.testing.assert_array_equal(params["conv1/7x7_s2"]["b"], bf)
    out = BNInception(params)(torch.from_numpy(rng.normal(size=(1, 64, 64, in_channels))
                                               .astype(np.float32)))
    assert out["global_pool"].shape == (1, 1024)
    assert torch.isfinite(out["fc-action"]).all()


def test_save_npz_bytes_equal_jax(tmp_path, rng, monkeypatch):
    """save_npz of the same parameters writes the same file bytes as the
    JAX package's (one frozen clock for the zip members' stamps)."""
    path = synthetic_caffemodel(tmp_path / "m.caffemodel", rng)
    params = convert_caffe.convert(path)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    convert_caffe.save_npz(params, str(tmp_path / "port.npz"))
    jconvert.save_npz(jconvert.convert(path), str(tmp_path / "jax.npz"))
    assert (tmp_path / "port.npz").read_bytes() == (tmp_path / "jax.npz").read_bytes()
    assert_params_equal(convert_caffe.load_npz(str(tmp_path / "port.npz")), params)
    assert tsn.load_npz is convert_caffe.load_npz


def test_convert_cli_roundtrip(tmp_path, rng, monkeypatch):
    """`python -m videoquery_torch.nn.convert_caffe` converts an rgb model
    (no BN layers) to the JAX converter's parameters; in process, under one
    clock, the CLI writes the JAX CLI's bytes for a flow model; the port's
    TSN loads the two bundles and embeds."""
    rgb = synthetic_caffemodel(tmp_path / "rgb.caffemodel", rng, 3, bn=False)
    flow = synthetic_caffemodel(tmp_path / "flow.caffemodel", rng, 10)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "videoquery_torch.nn.convert_caffe", rgb,
                        "--stream", "rgb", "--out", str(tmp_path / "w" / "rgb_split1.npz")],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "converted 70 layers" in r.stdout, r.stdout + r.stderr
    assert_params_equal(convert_caffe.load_npz(str(tmp_path / "w" / "rgb_split1.npz")),
                        jconvert.convert(rgb, in_channels=3))
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    out = tmp_path / "w" / "flow_split1.npz"
    convert_caffe.main([flow, "--stream", "flow", "--out", str(out)])
    jconvert.main([flow, "--stream", "flow", "--out", str(tmp_path / "jax.npz")])
    assert out.read_bytes() == (tmp_path / "jax.npz").read_bytes()
    model = tsn.TwoStreamTSN.from_npz_dir(str(tmp_path / "w"), splits=(1,), device="cpu")
    sig = model.clip_signature(torch.zeros((1, 2, 64, 64, 3)), torch.zeros((1, 2, 64, 64, 10)))
    assert sig["rgb"].shape == sig["warped_optical_flow"].shape == (1, 1, 1024)
    assert all(torch.isfinite(v).all() for v in sig.values())
