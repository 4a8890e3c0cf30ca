"""I3D, the two-stream Inflated 3D ConvNet, as a PyTorch module.

Carreira & Zisserman, "Quo Vadis, Action Recognition? A New Model and the
Kinetics Dataset", CVPR 2017 (arXiv:1705.07750): Inception-v1 with every
filter and pool inflated to 3D, the layer list and widths of
``github.com/deepmind/kinetics-i3d``'s ``i3d.py`` (``InceptionI3d``). Every
conv is a ``Unit3D`` (a 3D conv without bias, BN, ReLU); BN is folded into
the conv's weight and bias, as ``BNInception`` holds its BN, so the module
holds only convs (OIDHW weights) and the logits head. Padding is
TensorFlow's ``SAME``: ``out = ceil(n / s)``, the ``max((out - 1) * s + k -
n, 0)`` padded cells split with the odd one at the end, zeros for a conv
and -inf for a max pool.

A ``Mixed`` block has four branches, concatenated on channels: a 1x1x1
conv; 1x1x1 then 3x3x3; 1x1x1 then 3x3x3 (3x3x3, not GoogLeNet's 5x5); a
3x3x3 stride-1 max pool then 1x1x1. The published logits are an AvgPool3d
2x7x7 VALID over ``Mixed_5c`` (224x224 input: 7x7 positions), a 1x1x1 conv
with bias, averaged over time. ``embed`` returns the tensor that conv
reads, averaged over time as the logits are: ``mean_t((m[t] + m[t+1]) /
2)``, ``m[t]`` the spatial mean of ``Mixed_5c`` at time t (with one time
step left, that step's mean). It equals the pool at 224x224 and is defined
at any size; the logits are the head applied to it (the conv is linear).

Inputs are channels-last volumes ``[N, T, H, W, C]`` at the public
functions and activations stay channels-last-3d (NDHWC), so cuDNN's
convolutions run on contiguous views and on the tensor cores. The net runs
in the dtype of its input, float32 or bfloat16: each conv reads
activations and weights in that type (weights cast once and cached,
dropped when a parameter changes) and sums their products in float32. On
the card one fused cuDNN call (``torch.cudnn_convolution_relu``) adds the
bias (in the activation type) and applies ReLU to the float32 sum and
rounds once. Elsewhere (the CPU tests) the conv is ``F.conv3d``: in float32
with the bias inside, in bfloat16 rounded once, then the float32 bias
added and rounded and ReLU (a zero bias, the seeded weights', leaves the
one rounding).

Two hand-written kernels take the layers that cuDNN runs worst:

- ``Conv3d_1a_7x7`` (7x7x7, stride 2, 3 or 2 channels) is one call of
  ``kernels/stem_conv3d.py`` (S1): in bfloat16 on the card one launch of a
  wgmma implicit GEMM that reads the NDHWC clip where it lies, SAME's zeros
  made in the kernel, with the float32 bias added to the float32 sum
  before the one rounding; on the CPU its plain version (``F.conv3d`` in
  float32 on an ``F.pad`` copy, then the same bias, ReLU and rounding). Its
  weight is packed once into S1's layout (``pack_weight``). A float32
  forward on the card runs the stem as cuDNN's stride-2 conv on the
  ``F.pad`` copy.
- A max pool is one call of ``kernels/max_pool3d.py`` (P1): on the card
  one launch of a hand-written NDHWC kernel that reads each input once and
  writes each output once, with SAME's padding computed in the kernel
  (cells past the input never win a max); on the CPU its plain version,
  ``F.max_pool2d`` on the [N * T, C, H, W] view and a max of strided t
  slices.

Spans (``core/profiling.py``): ``i3d.stem`` (``Conv3d_1a_7x7`` through
``MaxPool3d_3a_3x3``) and ``i3d.mixed`` (``Mixed_3b`` through ``Mixed_5c``
with the pools between), each with device events, and inside them
``i3d.stem_conv`` around the stem conv and ``i3d.pool`` around each of the
13 pools of a forward. The counters ``i3d.stem_conv_launches`` and
``i3d.pool_launches`` count S1's and the pools' kernel launches (1 and 13
a bfloat16 forward on the card, none on the CPU).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videoquery_torch.core.profiling import count, span
from videoquery_torch.kernels import max_pool3d, stem_conv3d
from videoquery_torch.kernels.max_pool3d import same_padding

NUM_CLASSES = 400        # Kinetics-400
EMBED_DIM = 1024         # Mixed_5c's channels
RGB_CHANNELS = 3         # RGB in [-1, 1]
FLOW_CHANNELS = 2        # TV-L1 (u, v) in [-1, 1]
STEM_CONV = "Conv3d_1a_7x7"
LOGITS = "Logits/Conv3d_0c_1x1"

# Mixed blocks' published widths: (b0, b1a, b1b, b2a, b2b, b3)
MIXED: dict[str, tuple[int, int, int, int, int, int]] = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}

# The layers in order: ("conv", name, kernel, stride, out channels),
# ("pool", name, kernel, stride) or ("mixed", name); kernels and strides
# (t, h, w). The stem is the first five.
LAYERS: tuple[tuple, ...] = (
    ("conv", "Conv3d_1a_7x7", (7, 7, 7), (2, 2, 2), 64),
    ("pool", "MaxPool3d_2a_3x3", (1, 3, 3), (1, 2, 2)),
    ("conv", "Conv3d_2b_1x1", (1, 1, 1), (1, 1, 1), 64),
    ("conv", "Conv3d_2c_3x3", (3, 3, 3), (1, 1, 1), 192),
    ("pool", "MaxPool3d_3a_3x3", (1, 3, 3), (1, 2, 2)),
    ("mixed", "Mixed_3b"),
    ("mixed", "Mixed_3c"),
    ("pool", "MaxPool3d_4a_3x3", (3, 3, 3), (2, 2, 2)),
    ("mixed", "Mixed_4b"),
    ("mixed", "Mixed_4c"),
    ("mixed", "Mixed_4d"),
    ("mixed", "Mixed_4e"),
    ("mixed", "Mixed_4f"),
    ("pool", "MaxPool3d_5a_2x2", (2, 2, 2), (2, 2, 2)),
    ("mixed", "Mixed_5b"),
    ("mixed", "Mixed_5c"),
)
STEM_LAYERS = 5

ONE = (1, 1, 1)
THREE = (3, 3, 3)

# a Mixed block's convs in the order of its widths
BRANCHES = ("Branch_0/Conv3d_0a_1x1", "Branch_1/Conv3d_0a_1x1", "Branch_1/Conv3d_0b_3x3",
            "Branch_2/Conv3d_0a_1x1", "Branch_2/Conv3d_0b_3x3", "Branch_3/Conv3d_0b_1x1")


def mixed_convs(name: str, cin: int) -> list[tuple[str, tuple, tuple, int, int]]:
    """A Mixed block's convs in order: (name, kernel, stride, cin, cout)."""
    b0, b1a, b1b, b2a, b2b, b3 = MIXED[name]
    return [(f"{name}/{branch}", k, ONE, ci, co) for branch, k, ci, co in zip(
        BRANCHES, (ONE, ONE, THREE, ONE, THREE, ONE), (cin, cin, b1a, cin, b2a, cin),
        (b0, b1a, b1b, b2a, b2b, b3))]


def conv_layers(in_channels: int) -> list[tuple[str, tuple, tuple, int, int]]:
    """Every Unit3D conv in topological order: (name, kernel, stride, cin,
    cout); the logits conv is not among them."""
    convs, cin = [], in_channels
    for layer in LAYERS:
        if layer[0] == "conv":
            _kind, name, k, s, cout = layer
            convs.append((name, k, s, cin, cout))
            cin = cout
        elif layer[0] == "mixed":
            convs += mixed_convs(layer[1], cin)
            b0, _b1a, b1b, _b2a, b2b, b3 = MIXED[layer[1]]
            cin = b0 + b1b + b2b + b3
    assert cin == EMBED_DIM, cin
    return convs


def pool_shapes(n: int, frames: int, h: int, w: int) -> list[tuple[str, tuple, tuple, tuple]]:
    """The 13 max pools of a forward over n volumes of frames x h x w, in
    order: (name, input shape [N, C, T, H, W], kernel, stride)."""
    dims, c, pools = (frames, h, w), 0, []
    for layer in LAYERS:
        if layer[0] == "conv":
            dims, c = tuple(-(-d // s) for d, s in zip(dims, layer[3])), layer[4]
        elif layer[0] == "pool":
            pools.append((layer[1], (n, c) + dims, layer[2], layer[3]))
            dims = tuple(-(-d // s) for d, s in zip(dims, layer[3]))
        else:
            pools.append((f"{layer[1]}/Branch_3/MaxPool3d_0a_3x3", (n, c) + dims, THREE, ONE))
            b0, _b1a, b1b, _b2a, b2b, b3 = MIXED[layer[1]]
            c = b0 + b1b + b2b + b3
    return pools


def init_params(seed: int, in_channels: int = RGB_CHANNELS,
                num_classes: int = NUM_CLASSES) -> dict[str, dict[str, np.ndarray]]:
    """Seeded parameters, BN-Inception's distribution: Xavier-uniform convs
    (DHWIO), zero biases, a logits head ([1024, classes]) of N(0, 1/1024)
    and zero bias, from numpy's generator."""
    rng = np.random.default_rng(int(seed))
    params: dict[str, dict[str, np.ndarray]] = {}
    for name, k, _s, cin, cout in conv_layers(in_channels):
        vol = math.prod(k)
        scale = np.sqrt(6.0 / (vol * cin + vol * cout))
        params[name] = {"w": rng.uniform(-scale, scale, k + (cin, cout)).astype(np.float32),
                        "b": np.zeros(cout, np.float32)}
    params[LOGITS] = {
        "w": (rng.standard_normal((EMBED_DIM, num_classes)) / np.sqrt(EMBED_DIM)
              ).astype(np.float32),
        "b": np.zeros(num_classes, np.float32)}
    return params


def conv_input(x: torch.Tensor, k: tuple, s: tuple) -> tuple[torch.Tensor, tuple]:
    """(input, padding) of a SAME conv of NCDHW x as cuDNN runs it: x and
    the symmetric padding where SAME is even, else x zero-padded by hand
    (F.pad)."""
    pads = [same_padding(n, kk, ss) for n, kk, ss in zip(x.shape[2:], k, s)]
    if all(a == b for a, b in pads):
        return x, tuple(a for a, _b in pads)
    flat = [p for a, b in reversed(pads) for p in (a, b)]     # w, h, t for F.pad
    return F.pad(x, flat), (0, 0, 0)


def takes_s1(x: torch.Tensor) -> bool:
    """Whether the stem conv of x launches S1 (``stem_conv3d.stem_conv``):
    bfloat16 on the card."""
    return x.is_cuda and x.dtype == torch.bfloat16


# max pool of NCDHW x with SAME padding: P1 on the card, its plain version on
# the CPU (module docstring)
max_pool_same = max_pool3d.max_pool_same


class InceptionI3d(nn.Module):
    """BN-folded I3D. ``embed`` takes a volume ``[N, T, H, W, C]``, float32
    or bfloat16, and returns float32 ``[N, 1024]``."""

    # embed takes a clip's volume [N, T, H, W, C], not images [N, H, W, C]
    temporal = True

    def __init__(self, params: dict[str, dict[str, np.ndarray]]):
        super().__init__()
        in_channels = params[STEM_CONV]["w"].shape[3]
        self.specs = {name: (k, s) for name, k, s, _ci, _co in conv_layers(in_channels)}
        self.weights = nn.ParameterDict()
        self.biases = nn.ParameterDict()
        for name in self.specs:
            key = name.replace("/", "__")
            w = np.asarray(params[name]["w"], np.float32).transpose(4, 3, 0, 1, 2)
            self.weights[key] = nn.Parameter(torch.from_numpy(np.ascontiguousarray(w)),
                                             requires_grad=False)
            self.biases[key] = nn.Parameter(
                torch.from_numpy(np.asarray(params[name]["b"], np.float32).copy()),
                requires_grad=False)
        self.logits_w = nn.Parameter(torch.from_numpy(
            np.asarray(params[LOGITS]["w"], np.float32).copy()), requires_grad=False)
        self.logits_b = nn.Parameter(torch.from_numpy(
            np.asarray(params[LOGITS]["b"], np.float32).copy()), requires_grad=False)
        # the conv weights in a working type, channels-last-3d, by (dtype,
        # device); dropped when a parameter's storage or version changes
        self._cast: dict[tuple, dict[str, torch.Tensor]] = {}
        self._cache_stamp: tuple | None = None

    def _check_cache(self) -> None:
        stamp = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if stamp != self._cache_stamp:
            self._cast.clear()
            self._cache_stamp = stamp

    def _weights(self, key: str, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(conv weight, bias) for input x: in x's dtype, channels-last-3d;
        the stem's bias in float32, and its weight packed for S1 where
        ``takes_s1(x)``."""
        device = self.weights[key].device
        cast = self._cast.get((x.dtype, device))
        if cast is None:
            cast = self._cast[(x.dtype, device)] = {}
            for k, v in self.weights.items():
                w, b = v.detach().to(x.dtype), self.biases[k].detach()
                if self.specs[k.replace("__", "/")][1] == ONE:
                    cast[k] = (w.contiguous(memory_format=torch.channels_last_3d), b.to(x.dtype))
                elif takes_s1(x):
                    cast[k] = (stem_conv3d.pack_weight(w), b.float())
                else:
                    cast[k] = (w.contiguous(memory_format=torch.channels_last_3d), b.float())
        return cast[key]

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        k, s = self.specs[name]
        key = name.replace("/", "__")
        w, b = self._weights(key, x)
        if s != ONE:
            with span("i3d.stem_conv", x.device):
                launches = stem_conv3d.LAUNCHES
                y = self._stem_conv(x, k, s, w, b)
                count("i3d.stem_conv_launches", stem_conv3d.LAUNCHES - launches)
            return y
        x, pad = conv_input(x, k, s)
        if x.is_cuda:
            return torch.cudnn_convolution_relu(x, w, b, ONE, pad, ONE, 1)
        if x.dtype == torch.float32:
            return F.relu(F.conv3d(x, w, b, padding=pad), inplace=True)
        y = F.conv3d(x, w, None, padding=pad)       # f32 sums, one rounding
        return y.add_(self.biases[key].view(1, -1, 1, 1, 1)).relu_()

    @staticmethod
    def _stem_conv(x: torch.Tensor, k: tuple, s: tuple, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
        """The stem conv with the float32 bias b: S1 (w packed), the plain
        version on the CPU, cuDNN's stride-2 conv in float32 on the card."""
        if takes_s1(x):
            return stem_conv3d.stem_conv(x, w, b)
        if not x.is_cuda:
            return stem_conv3d.stem_conv_reference(x, w, b)
        x, pad = conv_input(x, k, s)                # float32 on the card
        return torch.cudnn_convolution_relu(x, w, b, s, pad, ONE, 1)

    @staticmethod
    def _pool(x: torch.Tensor, k: tuple, s: tuple) -> torch.Tensor:
        with span("i3d.pool", x.device):
            launches = max_pool3d.LAUNCHES
            y = max_pool3d.max_pool_same(x, k, s)
            count("i3d.pool_launches", max_pool3d.LAUNCHES - launches)
        return y

    def _mixed(self, name: str, x: torch.Tensor) -> torch.Tensor:
        c = [f"{name}/{branch}" for branch in BRANCHES]
        b0 = self._conv(c[0], x)
        b1 = self._conv(c[2], self._conv(c[1], x))
        b2 = self._conv(c[4], self._conv(c[3], x))
        b3 = self._conv(c[5], self._pool(x, THREE, ONE))
        return torch.cat([b0, b1, b2, b3], dim=1)

    def _layer(self, layer: tuple, y: torch.Tensor) -> torch.Tensor:
        if layer[0] == "conv":
            return self._conv(layer[1], y)
        if layer[0] == "pool":
            return self._pool(y, layer[2], layer[3])
        return self._mixed(layer[1], y)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, head: bool = True) -> dict[str, torch.Tensor]:
        """[N, T, H, W, C] x -> {'global_pool': f32 [N, 1024], 'logits': f32
        [N, classes]} (the logits only with the head), both averaged over
        time (module docstring)."""
        self._check_cache()
        y = x.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
        with span("i3d.stem", x.device):
            for layer in LAYERS[:STEM_LAYERS]:
                y = self._layer(layer, y)
        with span("i3d.mixed", x.device):
            for layer in LAYERS[STEM_LAYERS:]:
                y = self._layer(layer, y)
        m = y.float().mean(dim=(3, 4))                  # [N, 1024, T']
        if m.shape[2] > 1:
            m = (m[:, :, :-1] + m[:, :, 1:]) / 2
        emb = m.mean(dim=2)
        out = {"global_pool": emb}
        if head:
            out["logits"] = emb @ self.logits_w + self.logits_b
        return out

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The 1024-d float32 signature of each volume of x [N, T, H, W, C]."""
        return self.forward(x, head=False)["global_pool"]
