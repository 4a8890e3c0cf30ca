"""BN-Inception's forward, plain PyTorch, from a weights dict.

The deploy prototxt's network (``tsn_bn_inception_{rgb,flow}_deploy``,
SURVEY.md C13) with its frozen BN layers folded into the convolutions, as
the port holds it: the layer list, Caffe's ceil-mode pools and the block
structure are frozen copies of ``videoquery_torch/nn/bn_inception.py``.
``embed`` runs it in float32 (TF32 off), or with ``cast`` rounding each
convolution's input and weights (the control's lower precision), and
returns the 1024-d ``global_pool`` of NHWC input.

``make_weights`` draws a stream's members on the card from a
``torch.Generator``: Xavier-uniform convolutions (the port's
``init_params`` distribution), zero biases, one call a member.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.flops import INCEPTION_BLOCKS

EMBED_DIM = 1024


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


def make_weights(generator: torch.Generator, in_channels: int, device) -> dict:
    """{conv name: (w OIHW f32, b f32)} of one member: one uniform draw for
    all its convolutions, scaled to each layer's Xavier bound."""
    layers = _conv_names(in_channels)
    sizes = [k * k * cin * cout for _n, k, _p, _s, cin, cout in layers]
    u = torch.rand(sum(sizes), generator=generator, device=device)
    out, off = {}, 0
    for (name, k, _p, _s, cin, cout), size in zip(layers, sizes):
        scale = math.sqrt(6.0 / (k * k * cin + k * k * cout))
        w = (u[off:off + size] * (2.0 * scale) - scale).reshape(cout, cin, k, k)
        out[name] = (w, torch.zeros(cout, device=device))
        off += size
    return out


def _conv(weights: dict, name: str, x: torch.Tensor, specs: dict, cast) -> torch.Tensor:
    k, pad, s = specs[name]
    w, b = weights[name]
    if cast is not None:
        x, w = cast(x), cast(w)
    return F.relu(F.conv2d(x, w, b, stride=s, padding=pad))


def _block(weights, name, b, x, specs, cast):
    branches = []
    if b["c1"]:
        branches.append(_conv(weights, f"{name}/1x1", x, specs, cast))
    r = _conv(weights, f"{name}/3x3_reduce", x, specs, cast)
    branches.append(_conv(weights, f"{name}/3x3", r, specs, cast))
    d = _conv(weights, f"{name}/double_3x3_reduce", x, specs, cast)
    d = _conv(weights, f"{name}/double_3x3_1", d, specs, cast)
    branches.append(_conv(weights, f"{name}/double_3x3_2", d, specs, cast))
    if b["stride"] == 1:
        pool = (avg_pool if b["pool"] == "ave" else max_pool)(x, 3, 1, 1)
        if b["pp"]:
            pool = _conv(weights, f"{name}/pool_proj", pool, specs, cast)
    else:
        pool = max_pool(x, 3, 2, 0)
    branches.append(pool)
    return torch.cat(branches, dim=1)


@torch.no_grad()
def embed(weights: dict, x: torch.Tensor, cast=None) -> torch.Tensor:
    """NHWC x -> f32 [N, 1024] global_pool, in float32 (TF32 off)."""
    in_channels = x.shape[-1]
    specs = {n: (k, p, s) for n, k, p, s, _ci, _co in _conv_names(in_channels)}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        y = x.float().permute(0, 3, 1, 2)
        y = _conv(weights, "conv1/7x7_s2", y, specs, cast)
        y = max_pool(y, 3, 2, 0)
        y = _conv(weights, "conv2/3x3_reduce", y, specs, cast)
        y = _conv(weights, "conv2/3x3", y, specs, cast)
        y = max_pool(y, 3, 2, 0)
        for name, b in INCEPTION_BLOCKS:
            y = _block(weights, name, b, y, specs, cast)
        return y.mean(dim=(2, 3))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
