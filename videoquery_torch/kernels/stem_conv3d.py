"""S1: I3D's stem conv, ``Conv3d_1a_7x7`` (``csrc/stem_conv3d.cu``).

Replaces no TPU kernel: it was added for I3D's first conv (``nn/i3d.py``).
``stem_conv(x, packed, bias)`` takes the clip x [N, C, T, H, W], C = 3
(rgb) or 2 (flow), the conv's weight in S1's layout (``pack_weight`` of
the OIDHW [64, C, 7, 7, 7] weight, in x's dtype) and a float32 bias [64],
and returns relu(conv(x) + bias), the 7x7x7 conv at stride 2 with
TensorFlow SAME padding (``same_padding``: ``ceil(n / 2)`` outputs an
axis, the odd padded cell at the end, zeros), [N, 64, ceil(T / 2),
ceil(H / 2), ceil(W / 2)] channels-last-3d (NDHWC in memory), in x's dtype:
products summed in float32, the bias added to the float32 sum, ReLU, one
rounding.

``stem_conv`` launches the kernel on a CUDA tensor and raises on
anything else; the plain PyTorch version beside it, for the CPU
(``stem_conv_reference``: ``F.conv3d`` in float32 on the SAME-padded input,
the float32 bias, ReLU, one rounding to x's dtype; any layout), takes the
OIDHW weight. ``LAUNCHES`` counts kernel launches. The kernel takes
bfloat16 x contiguous in channels-last-3d (the NDHWC clip as it lies:
``x.permute(0, 4, 1, 2, 3)`` of a contiguous [N, T, H, W, C] volume) on
16-byte aligned storage, a frame row (W * C * 2 bytes) of a multiple of 4
bytes (any width for flow, an even one for rgb), frames of fewer than 2**31
bytes, and a frame width whose staged rows fit shared memory
(``plan``; 224-wide frames take 71 KB of it). The kernel's K order and
tiles are in ``csrc/stem_conv3d.cu``; ``pack_weight`` lays the weight out
in that order.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from videoquery_torch.kernels import _launch
from videoquery_torch.kernels.max_pool3d import same_padding

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

COUT = 64                # the stem's output channels
TAPS = 7                 # the kernel's extent on each axis
STRIDE = 2
CHANNELS = (3, 2)        # rgb, flow
# the kernel's geometry (csrc/stem_conv3d.cu: kTile, kLead, kMaxSmem)
TILE = 512               # output positions a block's tile
LEAD = 8                 # elements before a staged row's pixel w = 0
MAX_SMEM = 232448

_ENTRY = _launch.Entry("stem_conv3d.cu", "vq_stem_conv3d", 13)


def window(c: int) -> int:
    """K cells of one (kt, kh) row: the 7 C values padded to a multiple of 8
    where that costs no k16 step (16 flow), else to an even count (22 rgb)."""
    even, eight = (TAPS * c + 1) & ~1, (TAPS * c + 7) & ~7
    return eight if -(-TAPS * eight // 16) == -(-TAPS * even // 16) else even


def k16_steps(c: int) -> int:
    """k16 steps of one kt: its 7 rows' K, padded to a multiple of 16."""
    return -(-TAPS * window(c) // 16)


@functools.lru_cache(maxsize=None)
def _k_index(c: int) -> tuple[int, ...]:
    """For each K position of a kt (16 * k16_steps(c) of them), its cell of
    the flattened (kh, kw, c) taps, or 49 * c (a zero) for the padding."""
    out = []
    for k in range(16 * k16_steps(c)):
        kh, e = divmod(k, window(c))
        out.append(kh * TAPS * c + e if kh < TAPS and e < TAPS * c else TAPS * TAPS * c)
    return tuple(out)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """OIDHW [64, C, 7, 7, 7] -> S1's layout [7, k16_steps(C), 8, 2, 8, 8]
    (kt, k16 step, 8-channel group, 8-deep K group, channel, K), in w's
    dtype and device: K position 16 s + 8 g + e of a kt is its (kh, kw, c)
    cell by ``_k_index``, zero for the padding."""
    cout, c = w.shape[:2]
    if w.shape != (COUT, c, TAPS, TAPS, TAPS) or c not in CHANNELS:
        raise ValueError(f"the stem's weight is [64, 3 or 2, 7, 7, 7]; got {tuple(w.shape)}")
    taps = w.permute(0, 2, 3, 4, 1).reshape(COUT, TAPS, TAPS * TAPS * c)
    taps = torch.cat([taps, taps.new_zeros(COUT, TAPS, 1)], dim=2)
    idx = torch.tensor(_k_index(c), device=w.device)
    k = taps[:, :, idx].reshape(8, 8, TAPS, k16_steps(c), 2, 8)
    return k.permute(2, 3, 0, 4, 1, 5).contiguous()


def unpack_weight(packed: torch.Tensor, c: int) -> torch.Tensor:
    """``pack_weight``'s inverse: S1's layout -> OIDHW [64, c, 7, 7, 7]
    (for the layout's tests; no path runs it)."""
    if packed.shape != (TAPS, k16_steps(c), 8, 2, 8, 8):
        raise ValueError(f"a packed stem weight for {c} channels is "
                         f"{(TAPS, k16_steps(c), 8, 2, 8, 8)}; got {tuple(packed.shape)}")
    k = packed.permute(2, 4, 0, 1, 3, 5).reshape(COUT, TAPS, 16 * k16_steps(c))
    idx = torch.tensor(_k_index(c), device=packed.device)
    live = idx < TAPS * TAPS * c
    taps = k.new_zeros(COUT, TAPS, TAPS * TAPS * c)
    taps[:, :, idx[live]] = k[:, :, live]
    return taps.reshape(COUT, TAPS, TAPS, TAPS, c).permute(0, 4, 1, 2, 3)


def stem_conv_f32(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv(x, w) + bias) in float32 before the rounding: x [N, C, T,
    H, W] and the OIDHW weight widened to float32, zero-padded by SAME's
    rule, ``F.conv3d`` at stride 2, the float32 bias, ReLU."""
    flat = []
    for n in reversed(x.shape[2:]):
        flat += list(same_padding(n, TAPS, STRIDE))
    y = F.conv3d(F.pad(x.float(), flat), w.float(), stride=STRIDE)
    return y.add_(bias.float().view(1, -1, 1, 1, 1)).relu_()


def stem_conv_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: ``stem_conv_f32`` rounded once to x's dtype,
    channels-last-3d (module docstring)."""
    return stem_conv_f32(x, w, bias).to(x.dtype).contiguous(
        memory_format=torch.channels_last_3d)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's shared memory for frames of one size: ``rs`` bytes
    between staged rows, ``stage_rows`` rows a stage, ``stages`` stages,
    ``smem`` bytes in all."""

    rs: int
    stage_rows: int
    stages: int
    smem: int


def plan(h: int, w: int, c: int) -> Plan:
    """S1's shared memory for H x W frames of c channels: the packed
    weights, the bias, and a ring of 3 stages (2 where 3 do not fit) of the
    input rows a tile reads at one kt. Raises ValueError where 2 do not fit."""
    ho, wo = -(-h // STRIDE), -(-w // STRIDE)
    lead = LEAD - same_padding(w, TAPS, STRIDE)[0] * c
    # a window's reads: its K cells, or the padding past a kt's K read on
    # from its last row's start
    read = max(window(c), 16 * k16_steps(c) - (TAPS - 1) * window(c))
    reach = lead + 2 * (wo - 1) * c + read           # elements a row's windows span
    rs = -(-2 * max(reach, LEAD + w * c) // 16) * 16
    span = min(ho, (wo + TILE - 2) // wo + 1)       # output rows a tile touches
    stage_rows = STRIDE * (span - 1) + TAPS
    fixed = TAPS * k16_steps(c) * COUT * 16 * 2 + COUT * 4 + 16 * 3    # + bias, barriers
    for stages in (3, 2):
        smem = fixed + stages * stage_rows * rs
        if smem <= MAX_SMEM:
            return Plan(rs, stage_rows, stages, smem)
    raise ValueError(f"S1 stages {stage_rows} rows of {rs} bytes a step for {w}-wide frames "
                     f"of {c} channels: two stages take {fixed + 2 * stage_rows * rs} bytes "
                     f"of shared memory, more than {MAX_SMEM}")


def check_kernel_operands(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor) -> Plan:
    """The kernel's own checks (module docstring), on tensors of any
    device: raise ValueError on what it does not take, else its ``plan``."""
    if x.dim() != 5 or x.shape[1] not in CHANNELS:
        raise ValueError(f"x must be [N, 3 or 2, T, H, W]; got {tuple(x.shape)}")
    if packed.dtype != x.dtype or packed.device != x.device:
        raise ValueError(f"the packed weight must be {x.dtype} on {x.device}; got "
                         f"{packed.dtype} on {packed.device}")
    if bias.shape != (COUT,) or bias.dtype != torch.float32 or bias.device != x.device:
        raise ValueError(f"the bias must be float32 [64] on {x.device}; got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    n, c, t, h, w = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"S1 takes bfloat16 x; got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("S1 takes x contiguous in channels_last_3d (NDHWC)")
    if not packed.is_contiguous() or packed.shape != (TAPS, k16_steps(c), 8, 2, 8, 8):
        raise ValueError("S1 takes the weight as pack_weight lays it out")
    if not bias.is_contiguous():
        raise ValueError("S1 takes a contiguous bias")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("S1 takes x and the packed weight on 16-byte aligned storage")
    if (w * c * 2) % 4:
        raise ValueError(f"S1 takes frame rows of a multiple of 4 bytes (an even width for 3 "
                         f"channels); got {w} x {c}")
    if h * w * c * 2 >= 2 ** 31 or n * t >= 2 ** 31:
        raise ValueError(f"S1 takes frames of fewer than 2**31 bytes; got {h} x {w} x {c}")
    ho, wo, to = -(-h // STRIDE), -(-w // STRIDE), -(-t // STRIDE)
    tiles = n * to * -(-(ho * wo) // TILE)
    if ho * wo * COUT >= 2 ** 31 or tiles * TAPS >= 2 ** 31:
        raise ValueError(f"S1 takes output planes of fewer than 2**31 elements and fewer than "
                         f"2**31 / 7 tiles; got {ho} x {wo}, {tiles} tiles")
    return plan(h, w, c)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stem_conv(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The stem conv of x [N, C, T, H, W] (module docstring): one launch of
    the kernel on the card; raises ValueError on another device or on what
    the kernel does not take."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"S1 runs on CUDA, not {x.device}: the CPU takes "
                         "stem_conv_reference")
    pl = check_kernel_operands(x, packed, bias)
    n, c, t, h, w = x.shape
    out = torch.empty((n, COUT) + tuple(-(-d // STRIDE) for d in (t, h, w)), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last_3d)
    if out.numel():
        dev = x.get_device()
        _launch.launch(_ENTRY, "S1", dev, x.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), n, t, h, w, c, pl.rs, pl.stage_rows, pl.stages,
                       _sm_count(dev))
        LAUNCHES += 1
    return out
