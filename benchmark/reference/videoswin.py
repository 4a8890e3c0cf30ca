"""Video Swin Transformer's forward and test protocol, plain PyTorch, from
a weights dict.

Liu et al., arXiv:2106.13230, as ``github.com/SwinTransformer/
Video-Swin-Transformer``'s ``mmaction/models/backbones/swin_transformer.py``
runs ``SwinTransformer3D.forward``, followed literally (``get_window_size``,
``window_partition``, ``window_reverse``, ``compute_mask``, the relative
position index, ``WindowAttention3D``'s explicit ``q * scale @ k^T + bias
(+ mask)``, softmax, ``@ v``, the block's norm, pad, roll, partition,
reverse, roll back and unpad, ``PatchMerging``'s pad and concatenation
order), then the head's mean over (D, H, W); the input is mmaction2's test
protocol (``SampleFrames(32, 2, 4, test_mode=True)``, ``Resize(-1, 224)``,
``ThreeCrop(224)``, ImageNet ``Normalize`` in RGB order). A frozen copy of
``videoquery_torch/testing/videoswin_reference.py`` with the benchmark's
weights layout (torch tensors on the card, drawn by ``make_weights``); it
imports nothing of the program. ``embed`` runs it in float32 (TF32 off),
or with ``cast`` rounding the operands of every matrix product (the patch
projection's conv, every linear, ``q @ k^T`` and ``@ v``: the control's
lower precision).

Departures from the published code: seeded weights (``make_weights``:
every linear's and the patch projection's weight N(0, 1 / fan_in), their
biases N(0, 0.02^2), LayerNorm weight 1 and bias 0, each relative position
bias table N(0, 1); one draw on the card from a ``torch.Generator``), not
the Kinetics-400 checkpoint; dense weights [in, out], the patch projection
DHWIO; no dropout or drop path. The video is the system's segment of
frames decoded at 340x256; the resize runs in float32 by cv2's bilinear
rule and is not rounded to uint8. A segment's signature is the mean of its
views' pooled features (mmaction averages the views' class scores).
"""

from __future__ import annotations

import math
from functools import reduce
from operator import mul

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
MEAN = (123.675, 116.28, 103.53)   # RGB
STD = (58.395, 57.12, 57.375)
TABLE = "relative_position_bias_table"


def layer_shapes(config: dict, channels: int = 3) -> list[tuple[str, str, tuple]]:
    """Every parameter of the configuration but the head, in order:
    (layer, key, shape)."""
    c0, window, patch = config["embed_dim"], config["window_size"], config["patch_size"]
    out = [("patch_embed/proj", "w", tuple(patch) + (channels, c0)),
           ("patch_embed/proj", "b", (c0,)),
           ("patch_embed/norm", "w", (c0,)), ("patch_embed/norm", "b", (c0,))]
    rows = math.prod(2 * w - 1 for w in window)
    depths, heads, ratio = config["depths"], config["num_heads"], config["mlp_ratio"]
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = c0 * 2 ** i
        for j in range(depth):
            pre = f"layers/{i}/blocks/{j}"
            out += [(f"{pre}/norm1", "w", (c,)), (f"{pre}/norm1", "b", (c,)),
                    (f"{pre}/attn", TABLE, (rows, h)),
                    (f"{pre}/attn/qkv", "w", (c, 3 * c)), (f"{pre}/attn/qkv", "b", (3 * c,)),
                    (f"{pre}/attn/proj", "w", (c, c)), (f"{pre}/attn/proj", "b", (c,)),
                    (f"{pre}/norm2", "w", (c,)), (f"{pre}/norm2", "b", (c,)),
                    (f"{pre}/mlp/fc1", "w", (c, ratio * c)), (f"{pre}/mlp/fc1", "b", (ratio * c,)),
                    (f"{pre}/mlp/fc2", "w", (ratio * c, c)), (f"{pre}/mlp/fc2", "b", (c,))]
        if i + 1 < len(depths):
            out += [(f"layers/{i}/downsample/norm", "w", (4 * c,)),
                    (f"layers/{i}/downsample/norm", "b", (4 * c,)),
                    (f"layers/{i}/downsample/reduction", "w", (4 * c, 2 * c))]
    c = c0 * 2 ** (len(depths) - 1)
    return out + [("norm", "w", (c,)), ("norm", "b", (c,))]


def make_weights(generator: torch.Generator, config: dict, device) -> dict:
    """{layer: {key: f32 tensor}}: one normal draw for every parameter,
    scaled as the module docstring says."""
    shapes = layer_shapes(config)
    sizes = [math.prod(s) for _l, _k, s in shapes]
    z = torch.randn(sum(sizes), generator=generator, device=device)
    out: dict[str, dict[str, torch.Tensor]] = {}
    off = 0
    for (layer, key, shape), size in zip(shapes, sizes):
        if layer.split("/")[-1] in ("norm", "norm1", "norm2"):
            t = torch.full(shape, 1.0 if key == "w" else 0.0, device=device)
        elif key == TABLE:
            t = z[off:off + size].reshape(shape)
        elif key == "w":
            t = z[off:off + size].reshape(shape) / math.sqrt(math.prod(shape[:-1]))
        else:
            t = z[off:off + size].reshape(shape) * 0.02
        out.setdefault(layer, {})[key] = t
        off += size
    return out


# -- the test protocol ----------------------------------------------------------

def sample_frames(total_frames: int, clip_len: int, frame_interval: int,
                  num_clips: int) -> np.ndarray:
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
    """mmcv's ``rescale_size((w, h), (inf, short_side))``: the new (w, h)."""
    factor = min(np.inf / max(h, w), short_side / min(h, w))
    return int(w * float(factor) + 0.5), int(h * float(factor) + 0.5)


def _cv2_linear(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] matrix of cv2.resize INTER_LINEAR along one axis."""
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
    """mmaction2's ``ThreeCrop(size)``: offsets (0, 0), (2 step, 0), (step,
    0) along the longer side, in that order."""
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


def views(frames_u8: torch.Tensor, config: dict) -> torch.Tensor:
    """A segment's BGR uint8 frames [F, H, W, 3] -> its views [crops *
    clips, clip_len, crop, crop, 3] in float32, crop major."""
    clip_len = config["clip_len"]
    idx = sample_frames(frames_u8.shape[0], clip_len, config["frame_interval"],
                        config["num_clips"])
    x = frames_u8[torch.from_numpy(idx.reshape(-1)).to(frames_u8.device)]
    w, h = rescale_size(x.shape[2], x.shape[1], config["short_side"])
    x = normalize(resize(x, w, h))
    out = torch.stack(three_crop(x, config["crop_size"]))
    return out.reshape((-1, clip_len) + out.shape[2:])


# -- the backbone -----------------------------------------------------------------

def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _linear(w: dict, layer: str, x: torch.Tensor, cast) -> torch.Tensor:
    out = cast(x) @ cast(w[layer]["w"])
    return out + w[layer]["b"] if "b" in w[layer] else out


def _norm(w: dict, layer: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[layer]["w"], w[layer]["b"], LN_EPS)


def window_partition(x, window_size):
    B, D, H, W, C = x.shape
    x = x.view(B, D // window_size[0], window_size[0], H // window_size[1], window_size[1],
               W // window_size[2], window_size[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, reduce(mul, window_size), C)


def window_reverse(windows, window_size, B, D, H, W):
    x = windows.view(B, D // window_size[0], H // window_size[1], W // window_size[2],
                     window_size[0], window_size[1], window_size[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(B, D, H, W, -1)


def get_window_size(x_size, window_size, shift_size):
    use_window_size, use_shift_size = list(window_size), list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            use_shift_size[i] = 0
    return tuple(use_window_size), tuple(use_shift_size)


def relative_position_index(window_size) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(window_size[0]),
                                        torch.arange(window_size[1]),
                                        torch.arange(window_size[2]), indexing="ij"))
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
    mask_windows = window_partition(img_mask, window_size).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)) \
        .masked_fill(attn_mask == 0, float(0.0))


def window_attention(w: dict, layer: str, x, window_size, mask, cast):
    table = w[layer][TABLE]
    num_heads = table.shape[1]
    B_, N, C = x.shape
    qkv = _linear(w, f"{layer}/qkv", x, cast).reshape(B_, N, 3, num_heads, C // num_heads) \
        .permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (C // num_heads) ** -0.5
    attn = cast(q) @ cast(k).transpose(-2, -1)
    index = relative_position_index(window_size).to(table.device)
    bias = table[index[:N, :N].reshape(-1)].reshape(N, N, -1).permute(2, 0, 1).contiguous()
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(B_ // nW, nW, num_heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, num_heads, N, N)
    attn = attn.softmax(dim=-1)
    x = (cast(attn) @ cast(v)).transpose(1, 2).reshape(B_, N, C)
    return _linear(w, f"{layer}/proj", x, cast)


def block(w: dict, pre: str, x, mask_matrix, window_size, shift_size, cast):
    shortcut = x
    B, D, H, W, C = x.shape
    use_window, use_shift = get_window_size((D, H, W), window_size, shift_size)
    x = _norm(w, f"{pre}/norm1", x)
    pad_d1 = (use_window[0] - D % use_window[0]) % use_window[0]
    pad_b = (use_window[1] - H % use_window[1]) % use_window[1]
    pad_r = (use_window[2] - W % use_window[2]) % use_window[2]
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d1))
    _, Dp, Hp, Wp, _ = x.shape
    shifted = any(i > 0 for i in use_shift)
    if shifted:
        x = torch.roll(x, shifts=tuple(-s for s in use_shift), dims=(1, 2, 3))
    attn_windows = window_attention(w, f"{pre}/attn", window_partition(x, use_window),
                                    window_size, mask_matrix if shifted else None, cast)
    x = window_reverse(attn_windows.view(-1, *(use_window + (C,))), use_window, B, Dp, Hp, Wp)
    if shifted:
        x = torch.roll(x, shifts=use_shift, dims=(1, 2, 3))
    if pad_d1 > 0 or pad_r > 0 or pad_b > 0:
        x = x[:, :D, :H, :W, :].contiguous()
    x = shortcut + x
    h = F.gelu(_linear(w, f"{pre}/mlp/fc1", _norm(w, f"{pre}/norm2", x), cast))
    return x + _linear(w, f"{pre}/mlp/fc2", h, cast)


def patch_merging(w: dict, layer: str, x, cast):
    B, D, H, W, C = x.shape
    if (H % 2 == 1) or (W % 2 == 1):
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x0 = x[:, :, 0::2, 0::2, :]
    x1 = x[:, :, 1::2, 0::2, :]
    x2 = x[:, :, 0::2, 1::2, :]
    x3 = x[:, :, 1::2, 1::2, :]
    x = _norm(w, f"{layer}/norm", torch.cat([x0, x1, x2, x3], -1))
    return _linear(w, f"{layer}/reduction", x, cast)


def basic_layer(w: dict, i: int, x, window_size, cast):
    """``BasicLayer.forward`` on x [B, C, D, H, W]."""
    depth = sum(1 for layer in w if layer.startswith(f"layers/{i}/blocks/")
                and layer.endswith("/norm1"))
    shift_size = tuple(s // 2 for s in window_size)
    B, C, D, H, W = x.shape
    use_window, use_shift = get_window_size((D, H, W), window_size, shift_size)
    x = x.permute(0, 2, 3, 4, 1)
    Dp = int(np.ceil(D / use_window[0])) * use_window[0]
    Hp = int(np.ceil(H / use_window[1])) * use_window[1]
    Wp = int(np.ceil(W / use_window[2])) * use_window[2]
    attn_mask = compute_mask(Dp, Hp, Wp, use_window, use_shift, x.device)
    for j in range(depth):
        x = block(w, f"layers/{i}/blocks/{j}", x, attn_mask, window_size,
                  (0, 0, 0) if j % 2 == 0 else shift_size, cast)
    x = x.view(B, D, H, W, -1)
    if f"layers/{i}/downsample/norm" in w:
        x = patch_merging(w, f"layers/{i}/downsample", x, cast)
    return x.permute(0, 4, 1, 2, 3)


def patch_embed(w: dict, x, cast):
    """``PatchEmbed3D.forward`` on x [B, 3, D, H, W]."""
    pw = w["patch_embed/proj"]["w"]                                # DHWIO
    patch = pw.shape[:3]
    _, _, D, H, W = x.size()
    if W % patch[2] != 0:
        x = F.pad(x, (0, patch[2] - W % patch[2]))
    if H % patch[1] != 0:
        x = F.pad(x, (0, 0, 0, patch[1] - H % patch[1]))
    if D % patch[0] != 0:
        x = F.pad(x, (0, 0, 0, 0, 0, patch[0] - D % patch[0]))
    x = F.conv3d(cast(x), cast(pw.permute(4, 3, 0, 1, 2)), w["patch_embed/proj"]["b"],
                 stride=tuple(patch))
    D, Wh, Ww = x.size(2), x.size(3), x.size(4)
    c = x.shape[1]
    x = _norm(w, "patch_embed/norm", x.flatten(2).transpose(1, 2))
    return x.transpose(1, 2).view(-1, c, D, Wh, Ww)


@torch.no_grad()
def embed(w: dict, x: torch.Tensor, window_size, cast=None) -> torch.Tensor:
    """RGB volumes [B, T, H, W, 3] -> f32 [B, C], the mean over (D, H, W) of
    the final norm, in float32 (TF32 off)."""
    cast = cast or _same
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = patch_embed(w, x.float().permute(0, 4, 1, 2, 3), cast)
        i = 0
        while f"layers/{i}/blocks/0/norm1" in w:
            x = basic_layer(w, i, x.contiguous(), tuple(window_size), cast)
            i += 1
        return _norm(w, "norm", x.permute(0, 2, 3, 4, 1)).mean(dim=(1, 2, 3))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
