"""T2: roll of f32 planes by a shift held on the device (``csrc/roll.cu``).

Port of the TPU kernel of ``tools/mosaic_roll_repro.py`` (``pltpu.roll`` of
an f32 [H, W] tile by a dynamic shift read from scalar memory). ``roll``
takes x [N, H, W] f32 and rolls each plane along ``axis`` 0 (rows) or 1
(columns) by ``shift``, a one-element int32 tensor on x's device. The
kernel reads the shift itself, so it is never a launch argument and the
host never waits to learn it. Sign convention: ``np.roll``'s, the shift
taken modulo the axis length, negative shifts included.

A CUDA tensor launches the kernel, or raises; a CPU tensor takes the plain
PyTorch version beside it (``roll_reference``, ``torch.roll``).
``LAUNCHES`` counts kernel launches. A call moves 160 KB on the repro's
tile, so its host path is kept short: a few comparisons, one allocation,
one ctypes call with the arguments packed in one block
(``kernels/_launch.py``).
"""

from __future__ import annotations

import torch

from videoquery_torch.kernels import _launch

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

_ENTRY = _launch.Entry("roll.cu", "vq_roll", 7)


def roll_reference(x: torch.Tensor, shift: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain version: torch.roll of [N, H, W] along dim axis + 1 (reads the
    shift on the host)."""
    return torch.roll(x, int(shift.reshape(-1)[0]), dims=axis + 1)


def _check(x: torch.Tensor, shift: torch.Tensor, axis: int) -> None:
    if x.dtype is not torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be float32 [N, H, W]; got {x.dtype} {tuple(x.shape)}")
    if shift.dtype is not torch.int32 or shift.numel() != 1:
        raise ValueError(f"shift must be one int32 value; got {shift.dtype} "
                         f"{tuple(shift.shape)}")
    if axis != 0 and axis != 1:
        raise ValueError(f"axis must be 0 (rows) or 1 (columns); got {axis}")
    if shift.get_device() != x.get_device() or shift.is_cuda != x.is_cuda:
        raise ValueError("shift must lie on x's device (the kernel reads it there)")


def roll(x: torch.Tensor, shift: torch.Tensor, axis: int) -> torch.Tensor:
    """Roll each [H, W] plane of x along axis 0 or 1 by the device scalar
    ``shift`` (np.roll's convention)."""
    global LAUNCHES
    # the card's operands pass in a few cheap comparisons; anything else goes
    # on to _check and the plain version, which say what is wrong
    if (x.is_cuda and x.dtype is torch.float32 and shift.dtype is torch.int32
            and (axis == 0 or axis == 1) and x.dim() == 3 and shift.numel() == 1
            and x.get_device() == shift.get_device() and x.is_contiguous()
            and shift.is_contiguous() and x.numel() < 2 ** 31):
        n, h, w = x.shape
        out = torch.empty_like(x)
        _launch.launch(_ENTRY, "T2", x.get_device(), x.data_ptr(), shift.data_ptr(),
                       out.data_ptr(), n, h, w, axis)
        LAUNCHES += 1
        return out
    _check(x, shift, axis)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"T2 runs on CUDA or (plain version) the CPU, not {x.device}")
        return roll_reference(x, shift, axis)
    if not (x.is_contiguous() and shift.is_contiguous()):
        raise ValueError("T2 operands must be contiguous")
    raise ValueError("T2 takes fewer than 2**31 elements per launch")
