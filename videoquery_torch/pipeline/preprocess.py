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
TimeSformer's rgb input (arXiv:2102.05095, PySlowFast's defaults) takes
them too: RGB order, ``(x / 255 - 0.45) / 0.225``
(``preprocess_rgb_timesformer``). Video Swin's (arXiv:2106.13230,
mmaction2's test pipeline) resizes the short side to the crop size with the
same cv2 rule, takes ``ThreeCrop``'s three crops along the long side and
normalises with the ImageNet mean and std in RGB order
(``preprocess_rgb_videoswin``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from videoquery_torch.core.transfer import device_constant

# Caffe/TSN ImageNet means, BGR channel order.
BGR_MEAN = (104.0, 117.0, 123.0)
FLOW_MEAN = 128.0
# PySlowFast's DATA.MEAN and DATA.STD (every channel), of x / 255
SLOWFAST_MEAN, SLOWFAST_STD = 0.45, 0.225
# mmaction2's Normalize for ImageNet models, RGB order, of x in [0, 255]
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
# mmaction2's ThreeCrop, in its order: the start, the end and the middle of
# the longer side (left, right, middle of a landscape frame)
THREE_CROP = ("start", "end", "mid")


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
    if where in THREE_CROP:
        # ThreeCrop: one side is the crop's, the origins step (side - size) // 2
        # along the other
        k = {"start": 0, "end": 2, "mid": 1}[where]
        if h == size:
            return 0, k * ((w - size) // 2)
        if w == size:
            return k * ((h - size) // 2), 0
        raise ValueError(f"ThreeCrop({size}) needs a side of {size}; got {h}x{w}")
    raise ValueError(f"unknown crop {where!r}")


def short_side_size(w: int, h: int, short_side: int) -> tuple[int, int]:
    """The (w, h) of mmaction2's ``Resize(scale=(-1, short_side))`` (mmcv's
    rescale_size: both sides scaled by short_side / min(w, h), rounded
    half up)."""
    factor = short_side / min(w, h)
    return int(w * factor + 0.5), int(h * factor + 0.5)


def _resize(x: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """Resize [..., H, W, C] to (h, w) in f32, uncropped: _resize_crop's
    matmuls over every row of the interpolation matrices."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    x = x.float()
    if h_in != h:
        ah = device_constant(("cv2", h_in, h, 0, h), lambda: _cv2_linear_matrix(h_in, h),
                             x.device)
        x = torch.einsum("oH,...HWc->...oWc", ah, x)
    if w_in != w:
        aw = device_constant(("cv2", w_in, w, 0, w), lambda: _cv2_linear_matrix(w_in, w),
                             x.device)
        x = torch.einsum("oW,...HWc->...Hoc", aw, x)
    return x


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


def preprocess_rgb_timesformer(frames: torch.Tensor, resize_wh: tuple[int, int] = (340, 256),
                               crop_size: int = 224, crop: str = "center",
                               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """BGR frames [..., H, W, 3] -> TimeSformer's input: resized and cropped
    as preprocess_rgb does, in RGB order, (x / 255 - 0.45) / 0.225,
    computed in f32 and cast to ``dtype``."""
    x = _resize_crop(frames, resize_wh[0], resize_wh[1], crop_size, crop)
    return ((x.flip(-1) / 255.0 - SLOWFAST_MEAN) / SLOWFAST_STD).to(dtype)


def preprocess_rgb_videoswin(frames: torch.Tensor, positions: torch.Tensor,
                             crop_size: int = 224,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A clip's distinct sampled BGR frames [B, U, H, W, 3] and its views'
    positions among them [clips, T] -> Video Swin's input [B, 3 * clips, T,
    crop, crop, 3]: each frame resized to a short side of crop_size
    (``short_side_size``), in RGB order, (x - IMAGENET_MEAN) / IMAGENET_STD,
    computed in f32 and cast to ``dtype``, then ThreeCrop's crops of the
    views' frames, in mmaction2's order (crop major, then clip)."""
    h_in, w_in = frames.shape[-3:-1]
    w, h = short_side_size(w_in, h_in, crop_size)
    x = _resize(frames, w, h).flip(-1)
    mean = device_constant("imagenet_mean", lambda: np.asarray(IMAGENET_MEAN, np.float32),
                           x.device)
    std = device_constant("imagenet_std", lambda: np.asarray(IMAGENET_STD, np.float32),
                          x.device)
    x = ((x - mean) / std).to(dtype)
    crops = []
    for where in THREE_CROP:
        top, left = _crop_origin(h, w, crop_size, where)
        crops.append(x[..., top:top + crop_size, left:left + crop_size, :])
    return torch.stack(crops, 1)[:, :, positions].flatten(1, 2)


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
