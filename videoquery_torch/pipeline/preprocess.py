"""Preprocessing for the two TSN streams, on the device.

Port of ``videoquery/pipeline/preprocess.py``: cv2-exact bilinear resize
(``_cv2_linear_matrix``, copied: half-pixel sources, edge-clamped, no
antialiasing) fused with the crop as two matmuls, mean subtraction, and
dense_flow's 8-bit flow quantization. Crops are the center crop (``"tl"``
is the reference's literal first crop). The net inputs are computed in f32
and cast to the net's working type (``dtype``), as the JAX package does.

I3D's inputs (arXiv:1705.07750, kinetics-i3d; no counterpart in the JAX
package) take the same resize and crop: rgb in RGB order scaled to [-1, 1]
(``preprocess_rgb_i3d``), flow truncated to [-bound, bound] and scaled to
[-1, 1] without quantization (``scale_flow``, ``preprocess_flow_i3d``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from videoquery_torch.core.transfer import device_constant

# Caffe/TSN ImageNet means, BGR channel order.
BGR_MEAN = (104.0, 117.0, 123.0)
FLOW_MEAN = 128.0


@functools.lru_cache(maxsize=64)
def _cv2_linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] interpolation matrix reproducing cv2.resize
    INTER_LINEAR along one axis: src = (dst + 0.5) * n_in / n_out - 0.5,
    edge-clamped, two taps whatever the scale."""
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    f = src - i0
    f = np.where(i0 < 0, 0.0, f)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    a = np.zeros((n_out, n_in), np.float64)
    a[dst.astype(np.int64), i0] += 1.0 - f
    a[dst.astype(np.int64), i1] += f
    return a.astype(np.float32)


def _crop_origin(h: int, w: int, size: int, where: str) -> tuple[int, int]:
    if where == "center":
        return (h - size) // 2, (w - size) // 2
    if where == "tl":
        return 0, 0
    raise ValueError(f"unknown crop {where!r}")


def _resize_crop(x: torch.Tensor, w: int, h: int, size: int,
                 where: str) -> torch.Tensor:
    """Resize [..., H, W, C] to (h, w), then crop size x size, as one pair of
    matmuls over the crop window's rows of the interpolation matrices."""
    top, left = _crop_origin(h, w, size, where)
    h_in, w_in = x.shape[-3], x.shape[-2]
    x = x.float()
    if h_in != h:
        ah = device_constant(("cv2", h_in, h, top, size),
                             lambda: _cv2_linear_matrix(h_in, h)[top:top + size], x.device)
        x = torch.einsum("oH,...HWc->...oWc", ah, x)
    else:
        x = x[..., top:top + size, :, :]
    if w_in != w:
        aw = device_constant(("cv2", w_in, w, left, size),
                             lambda: _cv2_linear_matrix(w_in, w)[left:left + size], x.device)
        x = torch.einsum("oW,...HWc->...Hoc", aw, x)
    else:
        x = x[..., left:left + size, :]
    return x


def preprocess_rgb(frames: torch.Tensor, resize_wh: tuple[int, int] = (340, 256),
                   crop_size: int = 224, crop: str = "center",
                   dtype: torch.dtype = torch.float32,
                   precropped: bool = False) -> torch.Tensor:
    """BGR frames [..., H, W, 3] (uint8 or float) -> mean-subtracted crops
    for the rgb net, computed in f32 and cast to ``dtype`` (the net's
    working type). precropped: the host already resized and cropped them
    (decode.resize_crop_frames, ExtractionConfig.host_crop); only the mean
    subtraction remains."""
    if precropped:
        x = frames.float()
    else:
        x = _resize_crop(frames, resize_wh[0], resize_wh[1], crop_size, crop)
    x = x - device_constant("bgr_mean", lambda: np.asarray(BGR_MEAN, np.float32), x.device)
    return x.to(dtype)


def preprocess_flow(stacks: torch.Tensor, resize_wh: tuple[int, int] = (340, 256),
                    crop_size: int = 224, crop: str = "center",
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantized flow stacks [..., H, W, 10] (128 = no motion) -> net input,
    computed in f32 and cast to ``dtype``."""
    x = _resize_crop(stacks, resize_wh[0], resize_wh[1], crop_size, crop)
    return (x - FLOW_MEAN).to(dtype)


def preprocess_rgb_i3d(frames: torch.Tensor, resize_wh: tuple[int, int] = (340, 256),
                       crop_size: int = 224, crop: str = "center",
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """BGR frames [..., H, W, 3] -> I3D's rgb input: resized and cropped as
    preprocess_rgb does, in RGB order, x / 127.5 - 1, computed in f32 and
    cast to ``dtype``."""
    x = _resize_crop(frames, resize_wh[0], resize_wh[1], crop_size, crop)
    return (x.flip(-1) / 127.5 - 1.0).to(dtype)


def scale_flow(flow: torch.Tensor, bound: float = 20.0) -> torch.Tensor:
    """I3D's flow scaling: truncated to [-bound, bound], divided by bound
    (f32 in [-1, 1]; quantize_flow's counterpart)."""
    return torch.clamp(flow, -bound, bound) / bound


def preprocess_flow_i3d(flow: torch.Tensor, resize_wh: tuple[int, int] = (340, 256),
                        crop_size: int = 224, crop: str = "center",
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Scaled flow [..., h, w, 2] (scale_flow) -> I3D's flow input: resized
    and cropped as preprocess_flow does, cast to ``dtype``."""
    return _resize_crop(flow, resize_wh[0], resize_wh[1], crop_size, crop).to(dtype)


def quantize_flow(flow: torch.Tensor, bound: float = 20.0) -> torch.Tensor:
    """dense_flow's 8-bit quantization: clip to [-bound, bound], map to
    [0, 255] with round-half-to-even (build_wof_clips.py:70-73, -b 20)."""
    x = torch.clamp(flow, -bound, bound)
    return torch.round((x + bound) * (255.0 / (2.0 * bound))).to(torch.uint8)


def dequantize_flow(q: torch.Tensor, bound: float = 20.0) -> torch.Tensor:
    return q.float() * (2.0 * bound / 255.0) - bound
