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
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

_SOURCE = "roll.cu"


def roll_reference(x: torch.Tensor, shift: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain version: torch.roll of [N, H, W] along dim axis + 1 (reads the
    shift on the host)."""
    return torch.roll(x, int(shift.reshape(-1)[0]), dims=axis + 1)


_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The built T2 library with its C signature declared (built at the
    first launch, never at import)."""
    global _lib
    if _lib is None:
        from videoquery_torch.kernels import _build

        lib = _build.load(_SOURCE)
        lib.vq_roll.restype = ctypes.c_int
        lib.vq_roll.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _check(x: torch.Tensor, shift: torch.Tensor, axis: int) -> None:
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [N, H, W]; got {x.dtype} {tuple(x.shape)}")
    if shift.dtype != torch.int32 or shift.numel() != 1:
        raise ValueError(f"shift must be one int32 value; got {shift.dtype} "
                         f"{tuple(shift.shape)}")
    if shift.device != x.device:
        raise ValueError("shift must lie on x's device (the kernel reads it there)")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 (rows) or 1 (columns); got {axis}")


def roll(x: torch.Tensor, shift: torch.Tensor, axis: int) -> torch.Tensor:
    """Roll each [H, W] plane of x along axis 0 or 1 by the device scalar
    ``shift`` (np.roll's convention)."""
    global LAUNCHES
    _check(x, shift, axis)
    if x.device.type == "cpu":
        return roll_reference(x, shift, axis)
    if x.device.type != "cuda":
        raise ValueError(f"T2 runs on CUDA or (plain version) the CPU, not {x.device}")
    if not (x.is_contiguous() and shift.is_contiguous()):
        raise ValueError("T2 operands must be contiguous")
    n, h, w = x.shape
    if n * h * w >= 2 ** 31:
        raise ValueError("T2 takes fewer than 2**31 elements per launch")
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vq_roll(x.data_ptr(), shift.data_ptr(), out.data_ptr(), n, h, w,
                          axis, stream)
    if err != 0:
        raise RuntimeError(f"T2 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
