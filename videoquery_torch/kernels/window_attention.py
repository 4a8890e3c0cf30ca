"""W1: Video Swin's window attention core as one launch a block
(``csrc/window_attention.cu``).

Replaces no TPU kernel: it was added for Video Swin's blocks
(``nn/video_swin.py``), whose attention ran as one cuDNN SDPA call on a
stored [windows * heads, 1, N, N] bias-and-mask tensor.
``window_attention(qkv, table, views, dims, window, shift, table_window)``
takes a block's qkv output [views * N * windows, 3C] (rows in (view,
position, window) order, columns in (head, q/k/v, channel) order), its
relative position bias table [rows, heads] in float32 (any strides), the
block's tokens ``dims`` (D, H, W), its clamped ``window`` and ``shift``
(``get_window_size``) and the published window ``table_window`` the table
was made for, and returns the attention's output [views * N * windows, C]
in qkv's dtype, rows in the same order and the heads' channels side by
side (the row order ``proj`` reads): for every window, view and head,
``softmax(q k^T * hd^-0.5 + B[idx(i, j)] (+ M(i, j))) v`` with
``idx = relative_position_index(table_window)[:N, :N]`` and M the
published ``compute_mask`` (-100 between positions of different regions).

A CUDA tensor launches the kernel; any other raises. The plain PyTorch
version beside it, ``window_attention_reference``, is the op chain
``nn/video_swin.py`` ran before the kernel, and what the model runs on the
CPU: the bias and mask built in float32 from the block's geometry, which
the model gives it (``nn/video_swin.py::bias_geometry``: the table's
rows [N, N] and the shift mask [windows, N, N]), rounded once to the working type, and SDPA on the math
path. ``LAUNCHES`` counts kernel launches. The kernel computes the bias
and the mask itself: position i's table row base is ``d (2 wh - 1)(2 ww -
1) + h (2 ww - 1) + w`` of its (d, h, w) in the window, and its region id
follows from its window's coordinates and the shift, so no [N, N] tensor
exists on the card. It takes head dim 32, N <= 392, tables of at most
3,136 rows and 16-byte aligned qkv; bfloat16 runs the fast kernel,
float32 the simple one (the first version written).
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from videoquery_torch.kernels import _launch

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

HEAD_DIM = 32
MAX_POSITIONS = 392                  # a window of 8 x 7 x 7
MAX_TABLE_ROWS = 3136

_ENTRY = _launch.Entry("window_attention.cu", "vq_window_attention", 23)
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's variants: bfloat16, float32
_FAST, _SIMPLE = 0, 1


def table_rows(table_window) -> int:
    """Rows of the bias table of a window: prod(2 w - 1)."""
    return math.prod(2 * w - 1 for w in table_window)


def _sizes(qkv: torch.Tensor, table: torch.Tensor, window) -> tuple[int, int, int]:
    """(N, heads, C) of a block's operands."""
    return math.prod(window), table.shape[1], qkv.shape[1] // 3


def attention_bias(table: torch.Tensor, index: np.ndarray, mask: np.ndarray | None,
                   windows: int) -> torch.Tensor:
    """The bias and shift mask of a block, [windows * heads, 1, N, N] in
    float32: the table's rows at ``index`` [N, N], plus ``mask`` [windows,
    N, N] where the block shifts (None where it does not)."""
    n = index.shape[0]
    rows = torch.from_numpy(index.reshape(-1)).to(table.device)
    rel = table.float()[rows].view(n, n, -1).permute(2, 0, 1)          # [h, N, N]
    if mask is not None:
        full = rel[None] + torch.from_numpy(mask).to(rel)[:, None]
    else:
        full = rel[None].expand(windows, -1, -1, -1)
    return full.reshape(-1, 1, n, n)


def window_attention_reference(qkv: torch.Tensor, table: torch.Tensor, views: int,
                               index: np.ndarray, mask: np.ndarray | None) -> torch.Tensor:
    """Plain version: ``attention_bias`` rounded once to qkv's dtype as the
    additive mask of one SDPA call on the math path over q, k and v as
    strided views [windows * heads, views, N, hd] of qkv, its output moved
    to (view, position, window) rows."""
    n, heads, c = index.shape[0], table.shape[1], qkv.shape[1] // 3
    windows = qkv.shape[0] // (views * n)
    qkv = qkv.view(views, n, -1, 3, c // heads).permute(3, 2, 0, 1, 4)
    q, k, v = qkv.unbind(0)                                       # [nW * h, B, N, hd]
    bias = attention_bias(table, index, mask, windows).to(q.dtype).contiguous()
    with sdpa_kernel([SDPBackend.MATH]):
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=(c // heads) ** -0.5)
    return o.permute(1, 2, 0, 3).reshape(-1, c)


def _check(qkv, table, views: int, dims, window, shift, table_window) -> None:
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"qkv must be float32 or bfloat16; got {qkv.dtype}")
    if table.dtype != torch.float32 or table.device != qkv.device:
        raise ValueError(f"the table must be float32 on {qkv.device}; got {table.dtype} on "
                         f"{table.device}")
    if len(dims) != 3 or len(window) != 3 or len(shift) != 3 or len(table_window) != 3:
        raise ValueError("dims, window, shift and table_window are (d, h, w)")
    if any(w > t for w, t in zip(window, table_window)):
        raise ValueError(f"the window {tuple(window)} exceeds the table's {tuple(table_window)}")
    if table.dim() != 2 or table.shape[0] != table_rows(table_window):
        raise ValueError(f"the table must be [{table_rows(table_window)}, heads]; got "
                         f"{tuple(table.shape)}")
    n, heads, c = _sizes(qkv, table, window)
    windows = math.prod(-(-d // w) for d, w in zip(dims, window))
    if qkv.dim() != 2 or qkv.shape[1] % (3 * heads) or qkv.shape[0] != views * n * windows:
        raise ValueError(f"qkv must be [{views} * {n} * {windows}, 3 * heads * hd] with "
                         f"{heads} heads; got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")


def _check_kernel(qkv, table, window) -> None:
    """What only the kernel refuses."""
    n, heads, c = _sizes(qkv, table, window)
    if c // heads != HEAD_DIM:
        raise ValueError(f"W1 takes head dim {HEAD_DIM}; got {c // heads}")
    if n > MAX_POSITIONS:
        raise ValueError(f"W1 takes windows of at most {MAX_POSITIONS} positions; got {n}")
    if table.shape[0] > MAX_TABLE_ROWS:
        raise ValueError(f"W1 takes tables of at most {MAX_TABLE_ROWS} rows; got "
                         f"{table.shape[0]}")
    if qkv.data_ptr() % 16:
        raise ValueError("W1 takes 16-byte aligned qkv")


def window_attention(qkv: torch.Tensor, table: torch.Tensor, views: int, dims, window, shift,
                     table_window) -> torch.Tensor:
    """The attention of a block (module docstring): one launch of the
    kernel."""
    global LAUNCHES
    _check(qkv, table, views, dims, window, shift, table_window)
    if not qkv.is_cuda:
        raise ValueError(f"W1 runs on CUDA, not {qkv.device} (the plain version is "
                         "window_attention_reference)")
    _check_kernel(qkv, table, window)
    n, heads, c = _sizes(qkv, table, window)
    out = torch.empty(qkv.shape[0], c, dtype=qkv.dtype, device=qkv.device)
    variant = _SIMPLE if qkv.dtype is torch.float32 else _FAST
    counts = [-(-d // w) for d, w in zip(dims, window)]
    scale_bits = struct.unpack("<I", struct.pack("<f", HEAD_DIM ** -0.5))[0]
    _launch.launch(_ENTRY, "W1", qkv.get_device(), qkv.data_ptr(), table.data_ptr(),
                   out.data_ptr(), views, n, math.prod(counts), heads, *window, *counts,
                   *shift, *table_window, table.stride(0), table.stride(1), variant,
                   scale_bits)
    LAUNCHES += 1
    return out
