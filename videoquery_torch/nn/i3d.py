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

Two layouts keep the work on fast paths without changing the arithmetic:

- ``Conv3d_1a_7x7`` (7x7x7, stride 2) runs as a 4x4x4 stride-1 conv on the
  2x2x2 space-to-depth of its SAME-padded input, with the kernel zero-
  padded to 8x8x8: the same products plus zeros, over 8 C channels (24
  rgb, 16 flow), which cuDNN's tensor cores take; on C = 3 or 2 channels
  cuDNN falls back to a float32 CUDA-core kernel.
- A max pool runs its (h, w) window with ``F.max_pool2d`` on the
  [N * T, C, H, W] view (NHWC; cuDNN's 3D pool writes NCDHW) and its t
  window as a max of strided slices. SAME's padding is the pool's own
  ``padding=before`` with ``ceil_mode``, which gives ``ceil(n / s)`` windows
  in the same places; cells past the input never win a max.

Spans (``core/profiling.py``): ``i3d.stem`` (``Conv3d_1a_7x7`` through
``MaxPool3d_3a_3x3``) and ``i3d.mixed`` (``Mixed_3b`` through ``Mixed_5c``
with the pools between), each with device events.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videoquery_torch.core.profiling import span

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


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow's SAME padding of one axis of n cells: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_input(x: torch.Tensor, k: tuple, s: tuple) -> tuple[torch.Tensor, tuple]:
    """(input, padding) of a SAME conv of NCDHW x as the module runs it: a
    stride-1 conv takes x and the symmetric padding where SAME is even, else
    x zero-padded by hand (F.pad); the 7x7x7 stride-2 conv takes the
    space-to-depth input (with ``space_to_depth_weight``)."""
    if s != ONE:
        return space_to_depth_input(x), (0, 0, 0)
    pads = [same_padding(n, kk, ss) for n, kk, ss in zip(x.shape[2:], k, s)]
    if all(a == b for a, b in pads):
        return x, tuple(a for a, _b in pads)
    flat = [p for a, b in reversed(pads) for p in (a, b)]     # w, h, t for F.pad
    return F.pad(x, flat), (0, 0, 0)


def space_to_depth_input(x: torch.Tensor) -> torch.Tensor:
    """NCDHW x -> the 2x2x2 space-to-depth of its SAME padding for a 7x7x7
    stride-2 conv, [N, 8 C, out + 3, ...] with channels (bt, bh, bw, c):
    the SAME padding before, zeros after up to 2 * out + 6 cells an axis."""
    n, c = x.shape[:2]
    outs, flat = [], []
    for size in reversed(x.shape[2:]):
        out = -(-size // 2)
        before = same_padding(size, 7, 2)[0]
        flat += [before, 2 * out + 6 - size - before]
        outs.insert(0, out + 3)
    xp = F.pad(x, flat).permute(0, 2, 3, 4, 1)                 # [N, T2, H2, W2, C]
    t, h, w = outs
    y = xp.reshape(n, t, 2, h, 2, w, 2, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return y.reshape(n, t, h, w, 8 * c).permute(0, 4, 1, 2, 3)


def space_to_depth_weight(w: torch.Tensor) -> torch.Tensor:
    """OIDHW 7x7x7 w -> the 4x4x4 kernel over space_to_depth_input's
    channels: zero-padded to 8x8x8, tap 2a + b of an axis at (b, a)."""
    o, c = w.shape[:2]
    w8 = F.pad(w, (0, 1, 0, 1, 0, 1)).reshape(o, c, 4, 2, 4, 2, 4, 2)
    return w8.permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(o, 8 * c, 4, 4, 4)


def max_pool_same(x: torch.Tensor, k: tuple, s: tuple) -> torch.Tensor:
    """Max pool of NCDHW x (channels-last-3d) with SAME padding (module
    docstring): the (h, w) window on the NHWC images, then the t window."""
    n, c, t, h, w = x.shape
    (t0, t1), (ph, _), (pw, _) = [same_padding(d, kk, ss)
                                  for d, kk, ss in zip(x.shape[2:], k, s)]
    if k[1:] != (1, 1) or s[1:] != (1, 1):
        y = F.max_pool2d(x.transpose(1, 2).reshape(n * t, c, h, w), k[1:], s[1:],
                         padding=(ph, pw), ceil_mode=True)
        x = y.reshape(n, t, c, y.shape[2], y.shape[3]).transpose(1, 2)
    if k[0] == 1 and s[0] == 1:
        return x
    xp = F.pad(x, (0, 0, 0, 0, t0, t1), value=-math.inf)
    last = (-(-t // s[0]) - 1) * s[0] + 1
    y = xp[:, :, 0:last:s[0]]
    for i in range(1, k[0]):
        y = torch.maximum(y, xp[:, :, i:i + last:s[0]])
    return y


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

    def _weights(self, key: str, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(conv weight, bias) in ``dtype``, channels-last-3d (the stem's
        weight in its space-to-depth form)."""
        device = self.weights[key].device
        cast = self._cast.get((dtype, device))
        if cast is None:
            cast = self._cast[(dtype, device)] = {}
            for k, v in self.weights.items():
                w = v.detach()
                if self.specs[k.replace("__", "/")][1] != ONE:
                    w = space_to_depth_weight(w)
                cast[k] = (w.to(dtype).contiguous(memory_format=torch.channels_last_3d),
                           self.biases[k].detach().to(dtype))
        return cast[key]

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        k, s = self.specs[name]
        key = name.replace("/", "__")
        w, b = self._weights(key, x.dtype)
        x, pad = conv_input(x, k, s)
        if x.is_cuda:
            return torch.cudnn_convolution_relu(x, w, b, ONE, pad, ONE, 1)
        if x.dtype == torch.float32:
            return F.relu(F.conv3d(x, w, b, padding=pad), inplace=True)
        y = F.conv3d(x, w, None, padding=pad)       # f32 sums, one rounding
        return y.add_(self.biases[key].view(1, -1, 1, 1, 1)).relu_()

    def _mixed(self, name: str, x: torch.Tensor) -> torch.Tensor:
        c = [f"{name}/{branch}" for branch in BRANCHES]
        b0 = self._conv(c[0], x)
        b1 = self._conv(c[2], self._conv(c[1], x))
        b2 = self._conv(c[4], self._conv(c[3], x))
        b3 = self._conv(c[5], max_pool_same(x, THREE, ONE))
        return torch.cat([b0, b1, b2, b3], dim=1)

    def _layer(self, layer: tuple, y: torch.Tensor) -> torch.Tensor:
        if layer[0] == "conv":
            return self._conv(layer[1], y)
        if layer[0] == "pool":
            return max_pool_same(y, layer[2], layer[3])
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
