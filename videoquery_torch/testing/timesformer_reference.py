"""TimeSformer's forward pass in plain PyTorch, float32: the reference the
port's ``nn/timesformer.py`` is held to.

Bertasius, Wang & Torresani, arXiv:2102.05095, as
``github.com/facebookresearch/TimeSformer``'s ``timesformer/models/vit.py``
runs ``VisionTransformer.forward_features`` with
``attention_type='divided_space_time'``. The token rearranges follow
vit.py's ``einops.rearrange`` calls one by one (each written as the
reshape and permute it stands for, its pattern beside it), the patch
tokens in (h, w, t) order; each attention is vit.py's ``Attention``
literally: ``q @ k^T * head_dim^-0.5``, softmax, ``@ v``. Every op is a
plain ``torch`` call in float32, with TF32 off while it runs. No kernel,
no ``scaled_dot_product_attention``, no cache or batching trick, and
nothing of JAX, of ``videoquery``, or of the port's ``nn/``, ``kernels/``
or ``pipeline/`` is imported.

Departures from vit.py:

- Weights are seeded (``nn/timesformer.py::make_weights``'s tree, taken as
  a plain dict of numpy arrays or tensors), not the Kinetics-400
  checkpoint (not in the repository); dense weights are [in, out] and the
  patch projection HWIO.
- No dropout or drop path (inference), and no interpolation of the
  position or time embeddings: the volume has the embeddings' own sizes.
- ``sample_indices`` and ``preprocess`` are PySlowFast's test-time input
  (``temporal_sampling``'s linspace over the whole segment, ``/ 255``,
  ``tensor_normalize`` with mean 0.45 and std 0.225) with one 224 center
  crop, where the paper takes 3 spatial crops of a short side of 224.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

HEADS = 12
LN_EPS = 1e-6
MEAN, STD = 0.45, 0.225


def sample_indices(frame_cnt: int, num_samples: int) -> torch.Tensor:
    """PySlowFast's ``temporal_sampling`` over a whole segment:
    ``linspace(0, frame_cnt - 1, num_samples)``, clamped, truncated."""
    index = torch.linspace(0, frame_cnt - 1, num_samples)
    return torch.clamp(index, 0, frame_cnt - 1).long()


def preprocess(frames_u8: torch.Tensor, crop: int) -> torch.Tensor:
    """BGR uint8 frames [..., H, W, 3] -> RGB float32 [..., crop, crop, 3]:
    the center crop, (x / 255 - 0.45) / 0.225."""
    h, w = frames_u8.shape[-3:-1]
    top, left = (h - crop) // 2, (w - crop) // 2
    x = frames_u8[..., top:top + crop, left:left + crop, :].flip(-1).float()
    return (x / 255.0 - MEAN) / STD


def _p(params: dict, layer: str, key: str = "w") -> torch.Tensor:
    """A parameter as a float32 tensor: a numpy array on the CPU, a tensor
    where it lies."""
    return torch.as_tensor(params[layer][key], dtype=torch.float32)


def _linear(params: dict, layer: str, x: torch.Tensor) -> torch.Tensor:
    return x @ _p(params, layer) + _p(params, layer, "b")


def _norm(params: dict, layer: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), _p(params, layer), _p(params, layer, "b"), LN_EPS)


def attention(params: dict, layer: str, x: torch.Tensor, heads: int = HEADS) -> torch.Tensor:
    """vit.py's ``Attention.forward`` on x [B, N, C]."""
    b, n, c = x.shape
    qkv = _linear(params, f"{layer}/qkv", x).reshape(b, n, 3, heads, c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q @ k.transpose(-2, -1)) * (c // heads) ** -0.5
    attn = attn.softmax(dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(b, n, c)
    return _linear(params, f"{layer}/proj", x)


def block(params: dict, i: int, x: torch.Tensor, t: int, heads: int = HEADS) -> torch.Tensor:
    """vit.py's ``Block.forward`` (divided_space_time) on x [B, 1 + N T, C]."""
    pre = f"blocks/{i}"
    b, tokens, m = x.shape
    n = (tokens - 1) // t
    # Temporal
    xt = x[:, 1:, :]
    xt = xt.reshape(b * n, t, m)                                # 'b (h w t) m -> (b h w) t m'
    res_temporal = attention(params, f"{pre}/temporal_attn",
                             _norm(params, f"{pre}/temporal_norm1", xt), heads)
    res_temporal = res_temporal.reshape(b, n * t, m)            # '(b h w) t m -> b (h w t) m'
    res_temporal = _linear(params, f"{pre}/temporal_fc", res_temporal)
    xt = x[:, 1:, :] + res_temporal
    # Spatial
    init_cls_token = x[:, 0, :].unsqueeze(1)
    cls_token = init_cls_token.repeat(1, t, 1)
    cls_token = cls_token.reshape(b * t, m).unsqueeze(1)        # 'b t m -> (b t) m'
    xs = xt
    xs = xs.reshape(b, n, t, m).permute(0, 2, 1, 3).reshape(b * t, n, m)
    #                                                           'b (h w t) m -> (b t) (h w) m'
    xs = torch.cat((cls_token, xs), 1)
    res_spatial = attention(params, f"{pre}/attn", _norm(params, f"{pre}/norm1", xs), heads)
    # Taking care of CLS token
    cls_token = res_spatial[:, 0, :]
    cls_token = cls_token.reshape(b, t, m)                      # '(b t) m -> b t m'
    cls_token = torch.mean(cls_token, 1, True)                  # averaging for every frame
    res_spatial = res_spatial[:, 1:, :]
    res_spatial = res_spatial.reshape(b, t, n, m).permute(0, 2, 1, 3).reshape(b, n * t, m)
    #                                                           '(b t) (h w) m -> b (h w t) m'
    res = res_spatial
    x = xt
    # Mlp
    x = torch.cat((init_cls_token, x), 1) + torch.cat((cls_token, res), 1)
    h = F.gelu(_linear(params, f"{pre}/mlp/fc1", _norm(params, f"{pre}/norm2", x)))
    return x + _linear(params, f"{pre}/mlp/fc2", h)


def embed_tokens(params: dict, x: torch.Tensor) -> torch.Tensor:
    """vit.py's ``forward_features`` up to the blocks: RGB volumes [B, T, H,
    W, 3] -> tokens [B, 1 + N T, C]."""
    b, t = x.shape[:2]
    w = _p(params, "patch_embed")                               # HWIO
    x = x.permute(0, 1, 4, 2, 3).reshape((b * t,) + (x.shape[4], x.shape[2], x.shape[3]))
    #                                                           'b c t h w -> (b t) c h w'
    x = F.conv2d(x, w.permute(3, 2, 0, 1), _p(params, "patch_embed", "b"), stride=w.shape[0])
    x = x.flatten(2).transpose(1, 2)                            # [(b t), n, c]
    cls_tokens = _p(params, "embed", "cls").expand(x.size(0), 1, -1)
    x = torch.cat((cls_tokens, x), dim=1)
    x = x + _p(params, "embed", "pos")
    cls_tokens = x[:b, 0, :].unsqueeze(1)
    x = x[:, 1:]
    n, m = x.shape[1:]
    x = x.reshape(b, t, n, m).permute(0, 2, 1, 3).reshape(b * n, t, m)
    #                                                           '(b t) n m -> (b n) t m'
    x = x + _p(params, "embed", "time")
    x = x.reshape(b, n * t, m)                                  # '(b n) t m -> b (n t) m'
    return torch.cat((cls_tokens, x), dim=1)


@torch.no_grad()
def embed(params: dict, x: torch.Tensor, heads: int = HEADS) -> torch.Tensor:
    """RGB volumes [B, T, H, W, 3] -> f32 [B, C], ``norm(x)[:, 0]`` (float32,
    TF32 off)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        t = x.shape[1]
        x = embed_tokens(params, x.float())
        depth = sum(1 for layer in params if layer.endswith("/mlp/fc1"))
        for i in range(depth):
            x = block(params, i, x, t, heads)
        return _norm(params, "norm", x)[:, 0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
