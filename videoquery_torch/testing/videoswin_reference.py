"""Video Swin Transformer's forward pass and test protocol in plain PyTorch,
float32: the reference the port's ``nn/video_swin.py`` is held to.

Liu et al., "Video Swin Transformer" (arXiv:2106.13230), as
``github.com/SwinTransformer/Video-Swin-Transformer``'s
``mmaction/models/backbones/swin_transformer.py`` runs
``SwinTransformer3D.forward``, followed literally: ``get_window_size``,
``window_partition``, ``window_reverse``, ``compute_mask``, the relative
position index, ``WindowAttention3D``'s explicit ``q * scale @ k^T + bias
(+ mask)``, softmax, ``@ v``, ``SwinTransformerBlock3D``'s norm, pad,
roll, partition, reverse, roll back and unpad, ``PatchMerging``'s pad and
concatenation order, ``BasicLayer``'s mask and shifts; then the
``I3DHead``'s mean over (D, H, W). The test protocol is mmaction2's
``SampleFrames(clip_len=32, frame_interval=2, num_clips=4,
test_mode=True)``, ``Resize(scale=(-1, 224))``, ``ThreeCrop(224)`` and
``Normalize`` (ImageNet mean and std, RGB). Every op is a plain ``torch``
call in float32, with TF32 off while it runs. No kernel, no
``scaled_dot_product_attention``, no cache or batching trick, and nothing
of JAX, of ``videoquery``, or of the port's ``nn/``, ``kernels/`` or
``pipeline/`` is imported.

Departures from the published code:

- Weights are seeded (``nn/video_swin.py::make_weights``'s tree, taken as a
  plain dict of numpy arrays or tensors; each relative position bias table
  N(0, 1), where the published init is trunc-normal 0.02), not the
  Kinetics-400 checkpoint (not in the repository); dense weights are [in,
  out] and the patch projection DHWIO.
- No dropout or drop path (inference).
- The video ``SampleFrames`` samples is the system's segment of frames
  already decoded at 340x256; ``Resize`` runs in float32 (cv2's bilinear
  rule, as a pair of interpolation matrices) and does not round the
  resized frame to uint8 as mmcv's ``imresize`` of a uint8 image does.
- The signature is the mean over the 12 views of the pooled 1,024-d
  feature (``segment_signature``); mmaction averages the views' class
  scores.
"""

from __future__ import annotations

import functools
from functools import reduce
from operator import mul

import numpy as np
import torch
import torch.nn.functional as F

WINDOW = (8, 7, 7)
LN_EPS = 1e-5
MEAN = (123.675, 116.28, 103.53)   # RGB
STD = (58.395, 57.12, 57.375)
TABLE = "relative_position_bias_table"


# -- the test protocol ----------------------------------------------------------

def sample_frames(total_frames: int, clip_len: int = 32, frame_interval: int = 2,
                  num_clips: int = 4) -> np.ndarray:
    """mmaction2's ``SampleFrames`` in test mode (``_get_test_clips``, then
    ``out_of_bound_opt='loop'``): [num_clips, clip_len] 0-based frames."""
    ori_clip_len = clip_len * frame_interval
    avg_interval = (total_frames - ori_clip_len + 1) / float(num_clips)
    if total_frames > ori_clip_len - 1:
        base_offsets = np.arange(num_clips) * avg_interval
        clip_offsets = (base_offsets + avg_interval / 2.0).astype(np.int64)
    else:
        clip_offsets = np.zeros((num_clips,), dtype=np.int64)
    frame_inds = clip_offsets[:, None] + np.arange(clip_len)[None, :] * frame_interval
    return np.mod(frame_inds, total_frames)


def rescale_size(w: int, h: int, short_side: int) -> tuple[int, int]:
    """mmcv's ``rescale_size((w, h), (inf, short_side))``, which
    ``Resize(scale=(-1, short_side))`` uses: the new (w, h)."""
    factor = min(np.inf / max(h, w), short_side / min(h, w))
    return int(w * float(factor) + 0.5), int(h * float(factor) + 0.5)


@functools.lru_cache(maxsize=16)
def _cv2_linear(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] matrix of cv2.resize INTER_LINEAR along one axis:
    src = (dst + 0.5) * n_in / n_out - 0.5, edge-clamped, two taps."""
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    f = np.where(i0 < 0, 0.0, src - i0)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    a = np.zeros((n_out, n_in), np.float64)
    a[np.arange(n_out), i0] += 1.0 - f
    a[np.arange(n_out), i1] += f
    return torch.from_numpy(a.astype(np.float32))


def resize(frames: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """Frames [..., H, W, 3] -> float32 [..., h, w, 3], bilinear as cv2."""
    ah = _cv2_linear(frames.shape[-3], h).to(frames.device)
    aw = _cv2_linear(frames.shape[-2], w).to(frames.device)
    x = torch.einsum("oH,...HWc->...oWc", ah, frames.float())
    return torch.einsum("oW,...HWc->...Hoc", aw, x)


def three_crop(x: torch.Tensor, size: int) -> list[torch.Tensor]:
    """mmaction2's ``ThreeCrop(size)`` on frames [..., H, W, 3] with H or W
    equal to size: the (x, y) offsets (0, 0), (2 step, 0), (step, 0) along
    the longer side, in that order."""
    img_h, img_w = x.shape[-3:-1]
    if size == img_h:
        w_step = (img_w - size) // 2
        offsets = [(0, 0), (2 * w_step, 0), (w_step, 0)]
    elif size == img_w:
        h_step = (img_h - size) // 2
        offsets = [(0, 0), (0, 2 * h_step), (0, h_step)]
    else:
        raise ValueError(f"ThreeCrop({size}) needs a side of {size}; got {img_h}x{img_w}")
    return [x[..., y:y + size, xo:xo + size, :] for xo, y in offsets]


def normalize(bgr: torch.Tensor) -> torch.Tensor:
    """Frames [..., 3] in BGR order, 0-255 -> RGB, (x - mean) / std."""
    x = bgr.flip(-1).float()
    return (x - torch.tensor(MEAN, device=x.device)) / torch.tensor(STD, device=x.device)


def views(frames_u8: torch.Tensor, clip_len: int = 32, frame_interval: int = 2,
          num_clips: int = 4, short_side: int = 224, crop: int = 224) -> torch.Tensor:
    """A segment's BGR uint8 frames [F, H, W, 3] -> its views [crops *
    clips, clip_len, crop, crop, 3] in float32, in mmaction2's order (crop
    major, then clip: ``FormatShape``'s reshape)."""
    idx = sample_frames(frames_u8.shape[0], clip_len, frame_interval, num_clips)
    x = frames_u8[torch.from_numpy(idx.reshape(-1)).to(frames_u8.device)]
    w, h = rescale_size(x.shape[2], x.shape[1], short_side)
    x = normalize(resize(x, w, h))
    out = torch.stack(three_crop(x, crop))                   # [crops, clips * T, ...]
    return out.reshape((-1, clip_len) + out.shape[2:])


# -- the backbone -----------------------------------------------------------------

def _p(params: dict, layer: str, key: str = "w") -> torch.Tensor:
    """A parameter as a float32 tensor: a numpy array on the CPU, a tensor
    where it lies."""
    return torch.as_tensor(params[layer][key], dtype=torch.float32)


def _linear(params: dict, layer: str, x: torch.Tensor) -> torch.Tensor:
    out = x @ _p(params, layer)
    return out + _p(params, layer, "b") if "b" in params[layer] else out


def _norm(params: dict, layer: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), _p(params, layer), _p(params, layer, "b"), LN_EPS)


def window_partition(x, window_size):
    """x [B, D, H, W, C] -> windows [B * num_windows, window_size product, C]."""
    B, D, H, W, C = x.shape
    x = x.view(B, D // window_size[0], window_size[0], H // window_size[1], window_size[1],
               W // window_size[2], window_size[2], C)
    windows = x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, reduce(mul, window_size),
                                                                   C)
    return windows


def window_reverse(windows, window_size, B, D, H, W):
    """windows [B * num_windows, WD, WH, WW, C] -> x [B, D, H, W, C]."""
    x = windows.view(B, D // window_size[0], H // window_size[1], W // window_size[2],
                     window_size[0], window_size[1], window_size[2], -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(B, D, H, W, -1)
    return x


def get_window_size(x_size, window_size, shift_size=None):
    use_window_size = list(window_size)
    if shift_size is not None:
        use_shift_size = list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            if shift_size is not None:
                use_shift_size[i] = 0
    if shift_size is None:
        return tuple(use_window_size)
    return tuple(use_window_size), tuple(use_shift_size)


def relative_position_index(window_size) -> torch.Tensor:
    """``WindowAttention3D``'s ``relative_position_index`` [N, N]."""
    coords_d = torch.arange(window_size[0])
    coords_h = torch.arange(window_size[1])
    coords_w = torch.arange(window_size[2])
    coords = torch.stack(torch.meshgrid(coords_d, coords_h, coords_w, indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += window_size[0] - 1
    relative_coords[:, :, 1] += window_size[1] - 1
    relative_coords[:, :, 2] += window_size[2] - 1
    relative_coords[:, :, 0] *= (2 * window_size[1] - 1) * (2 * window_size[2] - 1)
    relative_coords[:, :, 1] *= (2 * window_size[2] - 1)
    return relative_coords.sum(-1)


def compute_mask(D, H, W, window_size, shift_size, device):
    img_mask = torch.zeros((1, D, H, W, 1), device=device)
    cnt = 0
    for d in slice(-window_size[0]), slice(-window_size[0], -shift_size[0]), \
            slice(-shift_size[0], None):
        for h in slice(-window_size[1]), slice(-window_size[1], -shift_size[1]), \
                slice(-shift_size[1], None):
            for w in slice(-window_size[2]), slice(-window_size[2], -shift_size[2]), \
                    slice(-shift_size[2], None):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size)
    mask_windows = mask_windows.squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    attn_mask = attn_mask.masked_fill(attn_mask != 0, float(-100.0)) \
        .masked_fill(attn_mask == 0, float(0.0))
    return attn_mask


def window_attention(params: dict, layer: str, x, window_size, mask=None):
    """``WindowAttention3D.forward`` on x [B_, N, C] (window_size: the
    module's, whose index is cut to [:N, :N])."""
    table = _p(params, layer, TABLE)
    num_heads = table.shape[1]
    B_, N, C = x.shape
    qkv = _linear(params, f"{layer}/qkv", x).reshape(B_, N, 3, num_heads, C // num_heads) \
        .permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (C // num_heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    index = relative_position_index(window_size).to(table.device)
    relative_position_bias = table[index[:N, :N].reshape(-1)].reshape(N, N, -1)
    relative_position_bias = relative_position_bias.permute(2, 0, 1).contiguous()
    attn = attn + relative_position_bias.unsqueeze(0)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(B_ // nW, nW, num_heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, num_heads, N, N)
    attn = attn.softmax(dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(B_, N, C)
    return _linear(params, f"{layer}/proj", x)


def block(params: dict, pre: str, x, mask_matrix, window_size, shift_size):
    """``SwinTransformerBlock3D.forward`` on x [B, D, H, W, C]."""
    shortcut = x
    B, D, H, W, C = x.shape
    use_window, use_shift = get_window_size((D, H, W), window_size, shift_size)
    x = _norm(params, f"{pre}/norm1", x)
    pad_l = pad_t = pad_d0 = 0
    pad_d1 = (use_window[0] - D % use_window[0]) % use_window[0]
    pad_b = (use_window[1] - H % use_window[1]) % use_window[1]
    pad_r = (use_window[2] - W % use_window[2]) % use_window[2]
    x = F.pad(x, (0, 0, pad_l, pad_r, pad_t, pad_b, pad_d0, pad_d1))
    _, Dp, Hp, Wp, _ = x.shape
    if any(i > 0 for i in use_shift):
        shifted_x = torch.roll(x, shifts=(-use_shift[0], -use_shift[1], -use_shift[2]),
                               dims=(1, 2, 3))
        attn_mask = mask_matrix
    else:
        shifted_x = x
        attn_mask = None
    x_windows = window_partition(shifted_x, use_window)
    attn_windows = window_attention(params, f"{pre}/attn", x_windows, window_size, attn_mask)
    attn_windows = attn_windows.view(-1, *(use_window + (C,)))
    shifted_x = window_reverse(attn_windows, use_window, B, Dp, Hp, Wp)
    if any(i > 0 for i in use_shift):
        x = torch.roll(shifted_x, shifts=(use_shift[0], use_shift[1], use_shift[2]),
                       dims=(1, 2, 3))
    else:
        x = shifted_x
    if pad_d1 > 0 or pad_r > 0 or pad_b > 0:
        x = x[:, :D, :H, :W, :].contiguous()
    x = shortcut + x
    h = F.gelu(_linear(params, f"{pre}/mlp/fc1", _norm(params, f"{pre}/norm2", x)))
    return x + _linear(params, f"{pre}/mlp/fc2", h)


def patch_merging(params: dict, layer: str, x):
    """``PatchMerging.forward`` on x [B, D, H, W, C]."""
    B, D, H, W, C = x.shape
    pad_input = (H % 2 == 1) or (W % 2 == 1)
    if pad_input:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x0 = x[:, :, 0::2, 0::2, :]
    x1 = x[:, :, 1::2, 0::2, :]
    x2 = x[:, :, 0::2, 1::2, :]
    x3 = x[:, :, 1::2, 1::2, :]
    x = torch.cat([x0, x1, x2, x3], -1)
    x = _norm(params, f"{layer}/norm", x)
    return _linear(params, f"{layer}/reduction", x)


def basic_layer(params: dict, i: int, x, window_size):
    """``BasicLayer.forward`` on x [B, C, D, H, W]."""
    depth = sum(1 for layer in params if layer.startswith(f"layers/{i}/blocks/")
                and layer.endswith("/norm1"))
    shift_size = tuple(s // 2 for s in window_size)
    B, C, D, H, W = x.shape
    use_window, use_shift = get_window_size((D, H, W), window_size, shift_size)
    x = x.permute(0, 2, 3, 4, 1)                                  # 'b c d h w -> b d h w c'
    Dp = int(np.ceil(D / use_window[0])) * use_window[0]
    Hp = int(np.ceil(H / use_window[1])) * use_window[1]
    Wp = int(np.ceil(W / use_window[2])) * use_window[2]
    attn_mask = compute_mask(Dp, Hp, Wp, use_window, use_shift, x.device)
    for j in range(depth):
        x = block(params, f"layers/{i}/blocks/{j}", x, attn_mask, window_size,
                  (0, 0, 0) if j % 2 == 0 else shift_size)
    x = x.view(B, D, H, W, -1)
    if f"layers/{i}/downsample/norm" in params:
        x = patch_merging(params, f"layers/{i}/downsample", x)
    return x.permute(0, 4, 1, 2, 3)                               # 'b d h w c -> b c d h w'


def patch_embed(params: dict, x):
    """``PatchEmbed3D.forward`` on x [B, 3, D, H, W]: pad to whole
    patches, Conv3d, LayerNorm."""
    w = _p(params, "patch_embed/proj")                             # DHWIO
    patch = w.shape[:3]
    _, _, D, H, W = x.size()
    if W % patch[2] != 0:
        x = F.pad(x, (0, patch[2] - W % patch[2]))
    if H % patch[1] != 0:
        x = F.pad(x, (0, 0, 0, patch[1] - H % patch[1]))
    if D % patch[0] != 0:
        x = F.pad(x, (0, 0, 0, 0, 0, patch[0] - D % patch[0]))
    x = F.conv3d(x, w.permute(4, 3, 0, 1, 2), _p(params, "patch_embed/proj", "b"),
                 stride=tuple(patch))
    D, Wh, Ww = x.size(2), x.size(3), x.size(4)
    embed_dim = x.shape[1]
    x = x.flatten(2).transpose(1, 2)
    x = _norm(params, "patch_embed/norm", x)
    return x.transpose(1, 2).view(-1, embed_dim, D, Wh, Ww)


@torch.no_grad()
def embed(params: dict, x: torch.Tensor, window_size=WINDOW) -> torch.Tensor:
    """RGB volumes [B, T, H, W, 3] -> f32 [B, C]: ``SwinTransformer3D``'s
    forward and the head's mean over (D, H, W) (float32, TF32 off)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = x.float().permute(0, 4, 1, 2, 3)                       # [B, 3, T, H, W]
        x = patch_embed(params, x)
        i = 0
        while f"layers/{i}/blocks/0/norm1" in params:
            x = basic_layer(params, i, x.contiguous(), window_size)
            i += 1
        x = x.permute(0, 2, 3, 4, 1)                               # 'n c d h w -> n d h w c'
        x = _norm(params, "norm", x)
        return x.mean(dim=(1, 2, 3))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def segment_signature(params: dict, frames_u8: torch.Tensor, window_size=WINDOW,
                      **protocol) -> torch.Tensor:
    """A segment's BGR uint8 frames [F, H, W, 3] -> f32 [C]: the mean over
    its views (``views``, keyword arguments as there) of ``embed``."""
    return embed(params, views(frames_u8, **protocol), window_size).mean(0)
