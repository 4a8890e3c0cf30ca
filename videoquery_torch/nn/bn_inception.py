"""BN-Inception (the TSN backbone) as a PyTorch module.

Port of ``videoquery/nn/bn_inception.py``. Every BN layer of the reference
deploy nets is frozen, so BN is folded into the conv weights and biases and
the module holds only convs (OIHW weights) and the ``fc-action`` head.
Caffe's pooling arithmetic is kept: ceil-mode output sizes realised as
explicit bottom/right padding (-inf for max, 0 for average) and average
pooling over a constant k*k (PyTorch's own ``ceil_mode=True`` shrinks the
divisor of an overhanging window instead). ``conv1`` is a plain 7x7/s2 conv
(the JAX package's space-to-depth stem is a TPU workaround with the same
maths). Inputs are NHWC at the public functions, as in the JAX package.

The net runs in the dtype of its input, float32 or bfloat16, as the JAX
``apply`` does: each conv reads activations and weights in that type and
accumulates in float32 (cuDNN's bf16 convolution), the float32 bias is
added, then ReLU, then the result is cast back. cuDNN hands a bf16 conv's
sum back rounded to bf16 before the bias is added, so with a non-zero bias
a bf16 output may be rounded twice where the JAX package rounds once.
Average pooling works in the activation type; ``global_pool`` is a float32
mean. Weights are cast to a working type once, at its first use.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# Inception block channel spec (reference prototxt; see the JAX module).
INCEPTION_BLOCKS: tuple[tuple[str, dict], ...] = (
    ("inception_3a", dict(c1=64, r3=64, c3=64, rd=64, d1=96, d2=96, pool="ave", pp=32, stride=1)),
    ("inception_3b", dict(c1=64, r3=64, c3=96, rd=64, d1=96, d2=96, pool="ave", pp=64, stride=1)),
    ("inception_3c", dict(c1=0, r3=128, c3=160, rd=64, d1=96, d2=96, pool="max", pp=0, stride=2)),
    ("inception_4a", dict(c1=224, r3=64, c3=96, rd=96, d1=128, d2=128, pool="ave", pp=128, stride=1)),
    ("inception_4b", dict(c1=192, r3=96, c3=128, rd=96, d1=128, d2=128, pool="ave", pp=128, stride=1)),
    ("inception_4c", dict(c1=160, r3=128, c3=160, rd=128, d1=160, d2=160, pool="ave", pp=128, stride=1)),
    ("inception_4d", dict(c1=96, r3=128, c3=192, rd=160, d1=192, d2=192, pool="ave", pp=128, stride=1)),
    ("inception_4e", dict(c1=0, r3=128, c3=192, rd=192, d1=256, d2=256, pool="max", pp=0, stride=2)),
    ("inception_5a", dict(c1=352, r3=192, c3=320, rd=160, d1=224, d2=224, pool="ave", pp=128, stride=1)),
    ("inception_5b", dict(c1=352, r3=192, c3=320, rd=192, d1=224, d2=224, pool="max", pp=128, stride=1)),
)

NUM_CLASSES = 101        # UCF101 fc-action
EMBED_DIM = 1024         # global_pool width
RGB_CHANNELS = 3
FLOW_CHANNELS = 10       # 5 x/y flow pairs


def _conv_names(in_channels: int) -> list[tuple[str, int, int, int, int, int]]:
    """Every conv in topological order: (name, k, pad, stride, cin, cout)."""
    convs = [
        ("conv1/7x7_s2", 7, 3, 2, in_channels, 64),
        ("conv2/3x3_reduce", 1, 0, 1, 64, 64),
        ("conv2/3x3", 3, 1, 1, 64, 192),
    ]
    cin = 192
    for name, b in INCEPTION_BLOCKS:
        if b["c1"]:
            convs.append((f"{name}/1x1", 1, 0, 1, cin, b["c1"]))
        convs.append((f"{name}/3x3_reduce", 1, 0, 1, cin, b["r3"]))
        convs.append((f"{name}/3x3", 3, 1, b["stride"], b["r3"], b["c3"]))
        convs.append((f"{name}/double_3x3_reduce", 1, 0, 1, cin, b["rd"]))
        convs.append((f"{name}/double_3x3_1", 3, 1, 1, b["rd"], b["d1"]))
        convs.append((f"{name}/double_3x3_2", 3, 1, b["stride"], b["d1"], b["d2"]))
        if b["pp"]:
            convs.append((f"{name}/pool_proj", 1, 0, 1, cin, b["pp"]))
        cin = b["c1"] + b["c3"] + b["d2"] + (b["pp"] if b["pp"] else cin)
    assert cin == EMBED_DIM, cin
    return convs


def init_params(seed: int, in_channels: int = RGB_CHANNELS,
                num_classes: int = NUM_CLASSES) -> dict[str, dict[str, np.ndarray]]:
    """Xavier-uniform parameters in the JAX package's layout (HWIO convs,
    [cin, cout] head), from numpy's generator: the same seed gives the same
    weights as ``videoquery.nn.bn_inception.init_params``."""
    rng = np.random.default_rng(int(seed))
    params: dict[str, dict[str, np.ndarray]] = {}
    for name, k, _pad, _s, cin, cout in _conv_names(in_channels):
        fan_in, fan_out = k * k * cin, k * k * cout
        scale = np.sqrt(6.0 / (fan_in + fan_out))
        params[name] = {
            "w": rng.uniform(-scale, scale, (k, k, cin, cout)).astype(np.float32),
            "b": np.zeros(cout, np.float32),
        }
    params["fc-action"] = {
        "w": (rng.standard_normal((EMBED_DIM, num_classes))
              / np.sqrt(EMBED_DIM)).astype(np.float32),
        "b": np.zeros(num_classes, np.float32),
    }
    return params


def _ceil_pool_padding(size: int, k: int, s: int, pad: int) -> tuple[int, int]:
    """Caffe ceil-mode: out = ceil((size + 2*pad - k)/s) + 1, the last window
    clipped to start inside the padded input; the overhang becomes extra
    bottom/right padding."""
    out = math.ceil((size + 2 * pad - k) / s) + 1
    if pad > 0 and (out - 1) * s >= size + pad:
        out -= 1
    span = (out - 1) * s + k
    return pad, max(span - size - pad, 0)


def _caffe_pad(x: torch.Tensor, k: int, s: int, pad: int, value: float):
    ph = _ceil_pool_padding(x.shape[2], k, s, pad)
    pw = _ceil_pool_padding(x.shape[3], k, s, pad)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def max_pool(x: torch.Tensor, k: int, s: int, pad: int = 0) -> torch.Tensor:
    """Caffe MAX pooling of NCHW (ceil mode, -inf padding)."""
    return F.max_pool2d(_caffe_pad(x, k, s, pad, -math.inf), k, s)


def avg_pool(x: torch.Tensor, k: int, s: int, pad: int = 0) -> torch.Tensor:
    """Caffe AVE pooling of NCHW: zero padding, constant k*k denominator."""
    return F.avg_pool2d(_caffe_pad(x, k, s, pad, 0.0), k, s)


class BNInception(nn.Module):
    """BN-folded BN-Inception. ``forward`` takes NHWC float32 or bfloat16,
    as the JAX package's ``apply`` does, runs in that type and returns
    float32 {'global_pool': [B, 1024]} and, with the head, 'fc-action'
    [B, num_classes]."""

    def __init__(self, params: dict[str, dict[str, np.ndarray]]):
        super().__init__()
        in_channels = params["conv1/7x7_s2"]["w"].shape[2]
        self.specs = {name: (k, pad, s)
                      for name, k, pad, s, _ci, _co in _conv_names(in_channels)}
        self.weights = nn.ParameterDict()
        self.biases = nn.ParameterDict()
        for name in self.specs:
            key = name.replace("/", "__")
            w = torch.from_numpy(np.ascontiguousarray(
                np.asarray(params[name]["w"], np.float32).transpose(3, 2, 0, 1)))
            self.weights[key] = nn.Parameter(w, requires_grad=False)
            self.biases[key] = nn.Parameter(
                torch.from_numpy(np.asarray(params[name]["b"], np.float32).copy()),
                requires_grad=False)
        self.fc_w = nn.Parameter(torch.from_numpy(
            np.asarray(params["fc-action"]["w"], np.float32).copy()), requires_grad=False)
        self.fc_b = nn.Parameter(torch.from_numpy(
            np.asarray(params["fc-action"]["b"], np.float32).copy()), requires_grad=False)
        # conv weights cast to a working type other than float32, by
        # (dtype, device); filled at the first forward in that type
        self._cast: dict[tuple, dict[str, torch.Tensor]] = {}

    def _weight(self, key: str, dtype: torch.dtype) -> torch.Tensor:
        w = self.weights[key]
        if dtype == w.dtype:
            return w
        cast = self._cast.get((dtype, w.device))
        if cast is None:
            cast = self._cast[(dtype, w.device)] = {
                k: v.detach().to(dtype) for k, v in self.weights.items()}
        return cast[key]

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        k, pad, s = self.specs[name]
        key = name.replace("/", "__")
        w, b = self._weight(key, x.dtype), self.biases[key]
        if x.dtype == torch.float32:
            return F.relu(F.conv2d(x, w, b, stride=s, padding=pad), inplace=True)
        y = F.conv2d(x, w, stride=s, padding=pad)      # f32 sums, cast
        return y.float().add_(b[:, None, None]).relu_().to(x.dtype)

    def _inception(self, name: str, b: dict, x: torch.Tensor) -> torch.Tensor:
        branches = []
        if b["c1"]:
            branches.append(self._conv(f"{name}/1x1", x))
        r = self._conv(f"{name}/3x3_reduce", x)
        branches.append(self._conv(f"{name}/3x3", r))
        d = self._conv(f"{name}/double_3x3_reduce", x)
        d = self._conv(f"{name}/double_3x3_1", d)
        branches.append(self._conv(f"{name}/double_3x3_2", d))
        if b["stride"] == 1:
            pool = (avg_pool if b["pool"] == "ave" else max_pool)(x, 3, 1, 1)
            if b["pp"]:
                pool = self._conv(f"{name}/pool_proj", pool)
        else:
            pool = max_pool(x, 3, 2, 0)   # passthrough of reduction blocks
        branches.append(pool)
        return torch.cat(branches, dim=1)

    def forward(self, x: torch.Tensor, head: bool = True) -> dict[str, torch.Tensor]:
        y = x.permute(0, 3, 1, 2)                  # NHWC -> NCHW
        y = self._conv("conv1/7x7_s2", y)
        y = max_pool(y, 3, 2, 0)
        y = self._conv("conv2/3x3_reduce", y)
        y = self._conv("conv2/3x3", y)
        y = max_pool(y, 3, 2, 0)
        for name, b in INCEPTION_BLOCKS:
            y = self._inception(name, b, y)
        gp = y.float().mean(dim=(2, 3))             # global_pool [B, 1024], f32
        out = {"global_pool": gp}
        if head:
            out["fc-action"] = gp @ self.fc_w + self.fc_b
        return out

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The 1024-d float32 embedding (the `global_pool` blob) of NHWC
        input."""
        return self.forward(x, head=False)["global_pool"]
