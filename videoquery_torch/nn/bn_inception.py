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
``apply`` does: each conv reads activations and weights in that type, sums
their products in float32, adds the float32 bias, applies ReLU and rounds
the result once to that type. In bfloat16 the stem and the stride-2 blocks
run ``F.conv2d`` on the bf16 values widened to float32 with the bias inside
the call (exact products, float32 sums; on the card TF32 is allowed for the
forward, which holds a bf16 value exactly), and every stride-1 block is one
call of the fused kernel T1 (``kernels/inception_block.py::fused_inception``:
on the card the CUDA kernel, on the CPU its plain version). Activations stay
channels-last, so a block's NHWC view is contiguous and T1's output is the
next layer's input without a copy. Average pooling outside T1 works in the
activation type; ``global_pool`` is a float32 mean. Weights are cast to a
working type once, at its first use, and T1's block weights are laid out
once per (dtype, device); both caches are dropped whenever a parameter
changes (an optimizer step, a load), so a bf16 forward never runs stale
weights.

The parameters are frozen (``requires_grad=False``) unless a trainer turns
them on (``train/trainer.py``); the extractor's modules stay frozen. The
head takes the training-time dropout of the JAX ``apply``: a keep mask
drawn by the caller (``dropout_keep``), kept values divided by 1 - rate.
``to_params`` gives the weights back in the JAX package's layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videoquery_torch.kernels import inception_block as t1

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


def conv_shapes(in_channels: int = RGB_CHANNELS) -> dict[str, tuple]:
    """{conv name: HWIO weight shape (kh, kw, cin, cout)}, in topological
    order."""
    return {name: (k, k, cin, cout) for name, k, _p, _s, cin, cout in _conv_names(in_channels)}


def fold_bn(
    conv_w: np.ndarray, conv_b: np.ndarray,
    scale: np.ndarray, shift: np.ndarray,
    mean: np.ndarray, var: np.ndarray, eps: float = 1e-5,
) -> tuple[np.ndarray, np.ndarray]:
    """Fold a frozen BN (y = scale*(x-mean)/sqrt(var+eps) + shift) into the
    preceding HWIO conv. Every reference BN is frozen, so this is exact."""
    inv = scale / np.sqrt(var + eps)
    return conv_w * inv.reshape(1, 1, 1, -1), (conv_b - mean) * inv + shift


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

    # embed takes images [N, H, W, C] (a tick each), not a clip's volume
    temporal = False

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
        # conv weights rounded to a working type other than float32 and held
        # as float32, by (dtype, device); filled at the first forward in that type
        self._cast: dict[tuple, dict[str, torch.Tensor]] = {}
        # T1's weights of each stride-1 block, by (dtype, device)
        self._blocks: dict[tuple, dict[str, t1.BlockWeights]] = {}
        # the parameters' storage and version counters when the caches were
        # filled: an in-place update (optimizer step, copy_) bumps a version,
        # a reassignment changes a pointer, and either empties both caches
        self._cache_stamp: tuple | None = None

    def _check_caches(self) -> None:
        stamp = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if stamp != self._cache_stamp:
            self._cast.clear()
            self._blocks.clear()
            self._cache_stamp = stamp

    def _weight(self, key: str, dtype: torch.dtype) -> torch.Tensor:
        w = self.weights[key]
        if dtype == w.dtype:
            return w
        cast = self._cast.get((dtype, w.device))
        if cast is None:
            cast = self._cast[(dtype, w.device)] = {
                k: v.detach().to(dtype).float() for k, v in self.weights.items()}
        return cast[key]

    def _block_weights(self, name: str, spec: dict, x: torch.Tensor) -> t1.BlockWeights:
        blocks = self._blocks.setdefault((x.dtype, x.device), {})
        if name not in blocks:
            params = {}
            for key in self.weights:
                if key.startswith(name + "__"):
                    params[key.replace("__", "/")] = {
                        "w": self.weights[key].detach().permute(2, 3, 1, 0),  # OIHW -> HWIO
                        "b": self.biases[key].detach()}
            blocks[name] = t1.block_weights(params, name, spec, x.dtype, x.device)
        return blocks[name]

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        k, pad, s = self.specs[name]
        key = name.replace("/", "__")
        w, b = self._weight(key, x.dtype), self.biases[key]
        if x.dtype == torch.float32:
            return F.relu(F.conv2d(x, w, b, stride=s, padding=pad), inplace=True)
        # exact products of the bf16 values, f32 sums and bias, one rounding;
        # the widened copy is channels-last, so every later activation is
        y = F.conv2d(x.to(torch.float32, memory_format=torch.channels_last), w, b,
                     stride=s, padding=pad)
        return y.relu_().to(x.dtype)

    def _inception(self, name: str, b: dict, x: torch.Tensor) -> torch.Tensor:
        if b["stride"] == 1 and x.dtype != torch.float32:
            y = t1.fused_inception(self._block_weights(name, b, x), name, b,
                                   x.permute(0, 2, 3, 1))
            return y.permute(0, 3, 1, 2)
        return self._inception_unfused(name, b, x)

    def _inception_unfused(self, name: str, b: dict, x: torch.Tensor) -> torch.Tensor:
        """The block as one ``_conv`` a branch, the pools and a concat: every
        f32 block and the stride-2 ones (bf16 stride-1 blocks run T1)."""
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

    def forward(self, x: torch.Tensor, head: bool = True,
                keep: torch.Tensor | None = None,
                dropout_rate: float = 0.0) -> dict[str, torch.Tensor]:
        """NHWC x -> {'global_pool': f32 [B, 1024], 'fc-action': f32 [B, C]}
        (the latter only with the head). ``keep`` (bool [B, 1024], from
        ``dropout_keep``) applies dropout before fc-action: kept values are
        divided by 1 - dropout_rate, the others zeroed (the JAX ``apply``)."""
        if x.dtype != torch.float32:
            self._check_caches()
        if x.dtype == torch.float32 or not x.is_cuda:
            return self._forward(x, head, keep, dropout_rate)
        # bf16 on the card: TF32 for the widened stem and stride-2 convs
        # (a bf16 value is exact in TF32); the f32 networks keep it off
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return self._forward(x, head, keep, dropout_rate)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

    def _forward(self, x: torch.Tensor, head: bool, keep: torch.Tensor | None,
                 dropout_rate: float) -> dict[str, torch.Tensor]:
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
            h = gp
            if keep is not None:
                h = torch.where(keep, gp / (1.0 - dropout_rate), 0.0)
            out["fc-action"] = h @ self.fc_w + self.fc_b
        return out

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The 1024-d float32 embedding (the `global_pool` blob) of NHWC
        input."""
        return self.forward(x, head=False)["global_pool"]

    def to_params(self) -> dict[str, dict[str, np.ndarray]]:
        """The parameters as float32 numpy in the JAX package's layout, the
        inverse of the constructor: {conv name: {'w': HWIO, 'b': [cout]}},
        'fc-action': {'w': [1024, C], 'b': [C]}."""
        def host(t: torch.Tensor) -> np.ndarray:
            return t.detach().cpu().numpy().copy()

        params = {name: {"w": host(self.weights[name.replace("/", "__")].permute(2, 3, 1, 0)),
                         "b": host(self.biases[name.replace("/", "__")])}
                  for name in self.specs}
        params["fc-action"] = {"w": host(self.fc_w), "b": host(self.fc_b)}
        return params


def dropout_keep(seed: int, shape: tuple[int, ...], rate: float) -> torch.Tensor:
    """A dropout keep mask on the CPU: each entry True with probability
    1 - rate, drawn from a ``torch.Generator`` seeded by `seed`, so the same
    seed gives the same mask on every device and in every process."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.rand(shape, generator=g) < (1.0 - rate)
