"""The port's deploy-prototxt executor (videoquery_torch.nn.prototxt_net)
against the JAX package's (videoquery.nn.prototxt_net.apply_prototxt).

The reference deploy prototxts are not in the repository
(tests/test_nn.py's REF_PROTO); the executors are held to each other on a
prototxt text written here that uses every layer type the deploy nets use
(Convolution with stride and padding, frozen BN, ReLU, MAX and AVE pooling
with Caffe's ceil-mode overhang, Concat, Dropout, an InnerProduct over a
2x2 blob, so its NHWC flattening order counts), with the same random
parameters: rtol 1e-5 / atol 1e-6. Where the reference prototxt exists,
the executor also runs the port's BNInception's graph.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoquery.nn.prototxt_net import apply_prototxt as jax_apply_prototxt
from videoquery_torch.nn import bn_inception
from videoquery_torch.nn.prototxt_net import apply_prototxt

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

TINY = """
name: "tiny_every_layer"   # a comment the parser skips
input: "data"
input_dim: 2
input_dim: 3
input_dim: 23
input_dim: 23
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 8 kernel_size: 3 stride: 2 pad: 1 } }
layer { name: "conv1_bn" type: "BN" bottom: "conv1" top: "conv1" bn_param { frozen: true } }
layer { name: "conv1_relu" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "b/1x1" type: "Convolution" bottom: "pool1" top: "b/1x1"
        convolution_param { num_output: 4 kernel_size: 1 } }
layer { name: "b/relu_1x1" type: "ReLU" bottom: "b/1x1" top: "b/1x1" }
layer { name: "b/3x3" type: "Convolution" bottom: "pool1" top: "b/3x3"
        convolution_param { num_output: 6 kernel_size: 3 pad: 1 } }
layer { name: "b/pool" type: "Pooling" bottom: "pool1" top: "b/pool"
        pooling_param { pool: AVE kernel_size: 3 stride: 1 pad: 1 } }
layer { name: "b/output" type: "Concat" bottom: "b/1x1" bottom: "b/3x3" bottom: "b/pool"
        top: "b/output" }
layer { name: "global_pool" type: "Pooling" bottom: "b/output" top: "global_pool"
        pooling_param { pool: AVE kernel_size: 3 stride: 2 } }
layer { name: "dropout" type: "Dropout" bottom: "global_pool" top: "global_pool"
        dropout_param { dropout_ratio: 0.8 } }
layer { name: "fc-action" type: "InnerProduct" bottom: "global_pool" top: "fc-action"
        inner_product_param { num_output: 5 } }
"""

# where the JAX package's tests look for the reference deploy prototxts
from test_nn import REF_PROTO  # noqa: E402


def tiny_params(rng):
    shapes = {"conv1": (3, 3, 3, 8), "b/1x1": (1, 1, 8, 4), "b/3x3": (3, 3, 8, 6)}
    params = {n: {"w": rng.normal(size=s).astype(np.float32) * 0.3,
                  "b": rng.normal(size=s[-1]).astype(np.float32) * 0.3}
              for n, s in shapes.items()}
    # global_pool: 3x3 of 18 channels after the ceil-mode pools
    params["fc-action"] = {"w": rng.normal(size=(3 * 3 * 18, 5)).astype(np.float32) * 0.1,
                           "b": rng.normal(size=5).astype(np.float32)}
    return params


def test_executor_matches_jax_on_every_layer_type(tmp_path, rng):
    path = str(tmp_path / "tiny.prototxt")
    with open(path, "w") as f:
        f.write(TINY)
    params = tiny_params(rng)
    x = rng.normal(size=(2, 23, 23, 3)).astype(np.float32) * 50
    got = apply_prototxt(path, params, torch.from_numpy(x))
    want = jax_apply_prototxt(path, {n: {k: jnp.asarray(v) for k, v in p.items()}
                                     for n, p in params.items()}, jnp.asarray(x))
    assert got["global_pool"].shape == (2, 3 * 3 * 18)
    assert got["fc-action"].shape == (2, 5)
    for name in ("global_pool", "fc-action"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6)
    # the executor takes torch parameters as well
    tparams = {n: {k: torch.from_numpy(v) for k, v in p.items()} for n, p in params.items()}
    again = apply_prototxt(path, tparams, torch.from_numpy(x))
    assert torch.equal(again["fc-action"], got["fc-action"])


def test_executor_refuses_unknown_layers(tmp_path):
    path = str(tmp_path / "bad.prototxt")
    with open(path, "w") as f:
        f.write('layer { name: "lrn" type: "LRN" bottom: "data" top: "lrn" }')
    with pytest.raises(NotImplementedError, match="LRN"):
        apply_prototxt(path, {}, torch.zeros((1, 4, 4, 3)))


@pytest.mark.parametrize("stream,cin", [("rgb", 3), ("flow", 10)])
def test_executor_matches_bn_inception(stream, cin, rng):
    """The reference deploy graph against the port's transcription."""
    path = REF_PROTO.format(stream)
    if not os.path.exists(path):
        pytest.skip("reference prototxt unavailable")
    params = bn_inception.init_params(3, in_channels=cin)
    x = torch.from_numpy(rng.normal(size=(1, 224, 224, cin)).astype(np.float32) * 0.5)
    want = bn_inception.BNInception(params)(x)
    got = apply_prototxt(path, params, x)
    np.testing.assert_allclose(got["global_pool"].numpy(), want["global_pool"].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["fc-action"].numpy(), want["fc-action"].numpy(),
                               rtol=1e-4, atol=1e-4)
