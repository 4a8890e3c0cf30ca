"""P1: 3D max pool with TensorFlow SAME padding on channels-last-3d volumes
(``csrc/max_pool3d.cu``).

Replaces no TPU kernel: it was added for I3D's max pools (``nn/i3d.py``).
``max_pool_same(x, k, s)`` takes x [N, C, T, H, W], float32 or bfloat16,
a kernel k and a stride s (t, h, w), and returns the max over each window,
[N, C, ceil(T / st), ceil(H / sh), ceil(W / sw)], channels-last-3d (NDHWC
in memory) where x is. SAME pads ``max((out - 1) * s + k - n,
0)`` cells an axis, the odd one at the end (``same_padding``); cells past
the input never win a max. NaN propagates.

A CUDA tensor launches the kernel, or raises; a CPU tensor takes the plain
PyTorch version beside it (``max_pool_same_reference``: the (h, w) window
with ``F.max_pool2d`` on the [N * T, C, H, W] view, SAME's padding as the
pool's own ``padding=before`` with ``ceil_mode``, which gives ``ceil(n /
s)`` windows in the same places; then the t window as a max of strided
slices of a -inf padded copy; any layout). ``LAUNCHES`` counts kernel
launches. The kernel takes channels-last-3d input, a t window of at most 3
cells and a t stride of at most the t window (I3D's pools: 1x3x3 / (1, 2,
2), 3x3x3 / 1, 3x3x3 / 2 and 2x2x2 / 2), channels of a multiple of 16
bytes (every pool of the net) and 16-byte aligned storage.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from videoquery_torch.kernels import _launch

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

# the kernel's t window, held in registers
MAX_KT = 3

_ENTRY = _launch.Entry("max_pool3d.cu", "vq_max_pool3d", 14)
_DTYPES = (torch.float32, torch.bfloat16)


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow's SAME padding of one axis of n cells: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def max_pool_same_reference(x: torch.Tensor, k: tuple, s: tuple) -> torch.Tensor:
    """Plain version: the (h, w) window on the NHWC images, then the t
    window (module docstring)."""
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


def _check(x: torch.Tensor, k: tuple, s: tuple) -> None:
    if x.dim() != 5:
        raise ValueError(f"x must be [N, C, T, H, W]; got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16; got {x.dtype}")
    if len(k) != 3 or len(s) != 3 or min(*k, *s) < 1:
        raise ValueError(f"kernel and stride must be 3 positive sizes; got {k}, {s}")


def max_pool_same(x: torch.Tensor, k: tuple, s: tuple) -> torch.Tensor:
    """Max pool of x [N, C, T, H, W] over windows k with strides s and SAME
    padding: the kernel on the card, the plain version on the CPU."""
    global LAUNCHES
    k, s = tuple(k), tuple(s)
    _check(x, k, s)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"P1 runs on CUDA or (plain version) the CPU, not {x.device}")
        return max_pool_same_reference(x, k, s)
    n, c, t, h, w = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("P1 takes x contiguous in channels_last_3d (NDHWC)")
    if k[0] > MAX_KT or s[0] > k[0]:
        raise ValueError(f"P1 takes a t window of at most {MAX_KT} and a t stride of at "
                         f"most the t window; got {k}, {s}")
    if (c * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError("P1 takes channels of a multiple of 16 bytes on 16-byte aligned "
                         f"storage; got {c} x {x.dtype}")
    if h * w * c >= 2 ** 31:
        raise ValueError(f"P1 takes planes of fewer than 2**31 elements; got {h} x {w} x {c}")
    out = torch.empty((n, c) + tuple(-(-d // st) for d, st in zip((t, h, w), s)),
                      dtype=x.dtype, device=x.device, memory_format=torch.channels_last_3d)
    if out.numel():
        _launch.launch(_ENTRY, "P1", x.get_device(), x.data_ptr(), out.data_ptr(),
                       n, t, h, w, c, *k, *s, int(x.dtype is torch.bfloat16))
        LAUNCHES += 1
    return out
