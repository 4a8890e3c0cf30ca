"""N1: a residual add and the next LayerNorm in one pass over TimeSformer's
token rows (``csrc/add_norm.cu``).

Replaces no TPU kernel: it was added for TimeSformer's blocks
(``nn/timesformer.py``). ``add_norm(x, delta, weight, bias, frames, after,
eps)`` takes the residual stream x [B, 1 + N * T, D] (the CLS row, then
the patch rows in (h, w, t) order; T = ``frames``), float32 or bfloat16,
adds in place the output ``delta`` of the step ``after`` names, and returns
the next step's LayerNorm of the new x, in the row order that step's GEMM
reads (``AFTER``):

- ``"time"``: delta is ``temporal_fc``'s output [B * N * T, D], rows in
  x's patch order (or None: no add); returns ``norm1``'s input layout
  [B, T, 1 + N, D], each frame's [CLS; patches];
- ``"space"``: delta is the space attention's output [B * T * (1 + N), D];
  each patch row gains its own row, the CLS row the mean over the T frames
  of their rows (float32 sums rounded once, then added); returns [B, 1 + N
  * T, D] in token order;
- ``"mlp"``: delta is ``fc2``'s output [B * (1 + N * T), D]; returns the
  patch rows' LayerNorm [B, N * T, D].

Each sum is float32(x) + float32(delta) rounded once to x's dtype, as
``add_`` rounds; the LayerNorm's statistics are float32 from the rounded
new rows; weight and bias are [D] in x's dtype.

A CUDA tensor launches the kernel, or raises; a CPU tensor takes the plain
PyTorch version beside it (``add_norm_reference``: ``residual_add``, the
op chain ``nn/timesformer.py`` ran before the kernel, ``add_`` through
views, ``mean``, then ``torch.cat`` and ``F.layer_norm``). ``LAUNCHES``
counts kernel launches. The kernel takes contiguous tensors, a width of a
multiple of 16 bytes (the argument checks hold on the CPU too) and of at
most 4 KB, 16-byte aligned storage, and fewer than 2**31 rows.
"""

from __future__ import annotations

import struct

import torch
import torch.nn.functional as F

from videoquery_torch.kernels import _launch

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

# the step whose output is added: the kernel's layout code
AFTER = {"time": 0, "space": 1, "mlp": 2}
# a row the kernel holds in a warp's registers
MAX_ROW_BYTES = 4096

_ENTRY = _launch.Entry("add_norm.cu", "vq_add_norm", 12)
_DTYPES = (torch.float32, torch.bfloat16)


def _sizes(x: torch.Tensor, frames: int) -> tuple[int, int, int, int]:
    """(B, N, T, D) of the residual stream x [B, 1 + N * T, D]."""
    b, tokens, d = x.shape
    return b, (tokens - 1) // frames, frames, d


def residual_add(x: torch.Tensor, delta: torch.Tensor, frames: int, after: str) -> None:
    """The residual add of step ``after``'s output to x, in place, in plain
    PyTorch (the module docstring's layouts)."""
    b, n, t, d = _sizes(x, frames)
    if after == "time":
        x[:, 1:].add_(delta.view(b, -1, d))
    elif after == "space":
        r = delta.view(b, t, 1 + n, d)
        x[:, 0].add_(r[:, :, 0].mean(dim=1))
        x[:, 1:].view(b, n, t, d).add_(r[:, :, 1:].transpose(1, 2))
    else:
        x.add_(delta.view_as(x))


def add_norm_reference(x: torch.Tensor, delta: torch.Tensor | None, weight: torch.Tensor,
                       bias: torch.Tensor, frames: int, after: str,
                       eps: float) -> torch.Tensor:
    """Plain version: ``residual_add``, then the next LayerNorm over the
    layout it reads (module docstring)."""
    b, n, t, d = _sizes(x, frames)
    if delta is not None:
        residual_add(x, delta, frames, after)
    if after == "time":
        rows = torch.cat([x[:, :1, None].expand(b, t, 1, d),
                          x[:, 1:].view(b, n, t, d).transpose(1, 2)], dim=2)
    elif after == "space":
        rows = x
    else:
        rows = x[:, 1:]
    return F.layer_norm(rows, (d,), weight, bias, eps)


def _check(x, delta, weight, bias, frames: int, after: str) -> None:
    if after not in AFTER:
        raise ValueError(f"after must be one of {sorted(AFTER)}; got {after!r}")
    if x.dim() != 3 or frames < 1 or x.shape[1] < 1 + frames or (x.shape[1] - 1) % frames:
        raise ValueError(f"x must be [B, 1 + N * {frames}, D] with N >= 1; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16; got {x.dtype}")
    b, n, t, d = _sizes(x, frames)
    if (d * x.element_size()) % 16:
        raise ValueError(f"the width must be a multiple of 16 bytes; got {d} x {x.dtype}")
    if delta is None and after != "time":
        raise ValueError(f"after {after!r} takes a delta")
    # each operand and the rows of D it holds
    operands = [("x", x, b * (1 + n * t)), ("weight", weight, 1), ("bias", bias, 1)]
    if delta is not None:
        rows = {"time": b * n * t, "space": b * t * (1 + n), "mlp": b * (1 + n * t)}[after]
        operands.append(("delta", delta, rows))
    for name, a, rows in operands:
        if a.dtype != x.dtype or a.device != x.device:
            raise ValueError(f"{name} must be {x.dtype} on {x.device}; got {a.dtype} on "
                             f"{a.device}")
        if a.numel() != rows * d or a.shape[-1] != d:
            raise ValueError(f"{name} must hold {rows} rows of {d}; got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def add_norm(x: torch.Tensor, delta: torch.Tensor | None, weight: torch.Tensor,
             bias: torch.Tensor, frames: int, after: str, eps: float) -> torch.Tensor:
    """Add step ``after``'s output delta to x in place and return the next
    LayerNorm's output: the kernel on the card, the plain version on the
    CPU."""
    global LAUNCHES
    _check(x, delta, weight, bias, frames, after)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"N1 runs on CUDA or (plain version) the CPU, not {x.device}")
        return add_norm_reference(x, delta, weight, bias, frames, after, eps)
    b, n, t, d = _sizes(x, frames)
    if d * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"N1 takes rows of at most {MAX_ROW_BYTES} bytes; got {d} x {x.dtype}")
    if max(b * (1 + n * t), b * t * (1 + n)) >= 2 ** 31:
        raise ValueError(f"N1 takes fewer than 2**31 rows; got {tuple(x.shape)}")
    tensors = [x, weight, bias] + ([] if delta is None else [delta])
    if any(a.data_ptr() % 16 for a in tensors):
        raise ValueError("N1 takes 16-byte aligned storage")
    shape = {"time": (b, t, 1 + n, d), "space": (b, 1 + n * t, d), "mlp": (b, n * t, d)}[after]
    z = torch.empty(shape, dtype=x.dtype, device=x.device)
    if x.numel():
        eps_bits = struct.unpack("<I", struct.pack("<f", eps))[0]
        _launch.launch(_ENTRY, "N1", x.get_device(), x.data_ptr(),
                       0 if delta is None else delta.data_ptr(), weight.data_ptr(),
                       bias.data_ptr(), z.data_ptr(), b, n, t, d, AFTER[after],
                       int(x.dtype is torch.bfloat16), eps_bits)
        LAUNCHES += 1
    return z
