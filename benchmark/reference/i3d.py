"""I3D's forward, plain PyTorch, from a weights dict.

Carreira & Zisserman, arXiv:1705.07750, as kinetics-i3d's ``i3d.py``
builds ``InceptionI3d``: ``Unit3D`` convs (3D conv, BN, ReLU) with
TensorFlow ``SAME`` padding, ``SAME`` max pools, nine ``Mixed`` blocks
(1x1x1; 1x1x1 -> 3x3x3; 1x1x1 -> 3x3x3; 3x3x3 max pool -> 1x1x1), then
the logits' AvgPool3d 2x7x7 VALID averaged over time. A frozen copy of
``videoquery_torch/testing/i3d_reference.py`` with the benchmark's weights
layout; it imports nothing of the program. ``embed`` runs it in float32
(TF32 off), or with ``cast`` rounding each conv's input and weights (the
control's lower precision), and returns the 1024-d signature of NDHWC
volumes: the logits' pool over ``Mixed_5c`` (2 x H' x W' VALID, 2 x 7 x 7
at 224 x 224; one step's plane mean where one time step is left),
averaged over time.

Departures from ``i3d.py``: BN folded into each conv's weight and bias;
seeded weights (``make_weights``: Xavier-uniform convs, zero biases, drawn
on the card from a ``torch.Generator``, one call a member), not the
Kinetics-400 checkpoints; no logits conv (the signature is what it reads).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EMBED_DIM = 1024

# (b0, b1a, b1b, b2a, b2b, b3) of each Mixed block
MIXED_WIDTHS = {
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

# ("conv", name, kernel, stride, cout), ("pool", name, kernel, stride) or
# ("mixed", name), in order; kernels and strides (t, h, w)
LAYERS = (
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

_BRANCHES = ("Branch_0/Conv3d_0a_1x1", "Branch_1/Conv3d_0a_1x1", "Branch_1/Conv3d_0b_3x3",
             "Branch_2/Conv3d_0a_1x1", "Branch_2/Conv3d_0b_3x3", "Branch_3/Conv3d_0b_1x1")


def conv_layers(in_channels: int) -> list[tuple[str, tuple, int, int]]:
    """Every Unit3D conv in order: (name, kernel, cin, cout)."""
    out, cin = [], in_channels
    for layer in LAYERS:
        if layer[0] == "conv":
            out.append((layer[1], layer[2], cin, layer[4]))
            cin = layer[4]
        elif layer[0] == "mixed":
            b0, b1a, b1b, b2a, b2b, b3 = MIXED_WIDTHS[layer[1]]
            for branch, k, ci, co in zip(
                    _BRANCHES, ((1, 1, 1), (1, 1, 1), (3, 3, 3), (1, 1, 1), (3, 3, 3), (1, 1, 1)),
                    (cin, cin, b1a, cin, b2a, cin), (b0, b1a, b1b, b2a, b2b, b3)):
                out.append((f"{layer[1]}/{branch}", k, ci, co))
            cin = b0 + b1b + b2b + b3
    assert cin == EMBED_DIM, cin
    return out


def make_weights(generator: torch.Generator, in_channels: int, device) -> dict:
    """{conv name: (w [cout, cin, kt, kh, kw] f32, b f32)} of one member:
    one uniform draw for all its convolutions, scaled to each layer's
    Xavier bound."""
    layers = conv_layers(in_channels)
    sizes = [math.prod(k) * cin * cout for _n, k, cin, cout in layers]
    u = torch.rand(sum(sizes), generator=generator, device=device)
    out, off = {}, 0
    for (name, k, cin, cout), size in zip(layers, sizes):
        vol = math.prod(k)
        scale = math.sqrt(6.0 / (vol * cin + vol * cout))
        w = (u[off:off + size] * (2.0 * scale) - scale).reshape((cout, cin) + k)
        out[name] = (w, torch.zeros(cout, device=device))
        off += size
    return out


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow SAME: out = ceil(n / s); the padding total split with the
    extra cell at the end."""
    out = math.ceil(n / s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k, s, value: float) -> torch.Tensor:
    (t0, t1), (h0, h1), (w0, w1) = [same_pads(n, kk, ss)
                                    for n, kk, ss in zip(x.shape[2:], k, s)]
    return F.pad(x, (w0, w1, h0, h1, t0, t1), value=value)


def _unit3d(weights: dict, name: str, x: torch.Tensor, stride, cast) -> torch.Tensor:
    w, b = weights[name]
    x = _pad_same(x, tuple(w.shape[2:]), stride, 0.0)
    if cast is not None:
        x, w = cast(x), cast(w)
    return F.relu(F.conv3d(x, w, b, stride=stride))


def _max_pool(x: torch.Tensor, k, s) -> torch.Tensor:
    return F.max_pool3d(_pad_same(x, k, s, -math.inf), k, s)


def _mixed(weights: dict, name: str, x: torch.Tensor, cast) -> torch.Tensor:
    one = (1, 1, 1)
    c = [f"{name}/{b}" for b in _BRANCHES]
    b0 = _unit3d(weights, c[0], x, one, cast)
    b1 = _unit3d(weights, c[2], _unit3d(weights, c[1], x, one, cast), one, cast)
    b2 = _unit3d(weights, c[4], _unit3d(weights, c[3], x, one, cast), one, cast)
    b3 = _unit3d(weights, c[5], _max_pool(x, (3, 3, 3), one), one, cast)
    return torch.cat([b0, b1, b2, b3], dim=1)


@torch.no_grad()
def embed(weights: dict, x: torch.Tensor, cast=None) -> torch.Tensor:
    """NDHWC x [N, T, H, W, C] -> f32 [N, 1024], in float32 (TF32 off)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        y = x.float().permute(0, 4, 1, 2, 3)
        for layer in LAYERS:
            if layer[0] == "conv":
                y = _unit3d(weights, layer[1], y, layer[3], cast)
            elif layer[0] == "pool":
                y = _max_pool(y, layer[2], layer[3])
            else:
                y = _mixed(weights, layer[1], y, cast)
        kt = min(2, y.shape[2])
        pooled = F.avg_pool3d(y, (kt,) + tuple(y.shape[3:]), stride=1)
        return pooled.mean(dim=(2, 3, 4))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
