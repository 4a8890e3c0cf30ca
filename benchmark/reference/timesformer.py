"""TimeSformer's forward, plain PyTorch, from a weights dict.

Bertasius, Wang & Torresani, arXiv:2102.05095, as
``github.com/facebookresearch/TimeSformer``'s ``timesformer/models/vit.py``
runs ``VisionTransformer.forward_features`` with
``attention_type='divided_space_time'``: the token rearranges of vit.py
one by one (the patch tokens in (h, w, t) order), each attention literally
``q @ k^T * head_dim^-0.5``, softmax, ``@ v``. A frozen copy of
``videoquery_torch/testing/timesformer_reference.py`` with the benchmark's
weights layout (torch tensors on the card, drawn by ``make_weights``); it
imports nothing of the program. ``embed`` runs it in float32 (TF32 off),
or with ``cast`` rounding the operands of every matrix product (the patch
projection's conv, every linear, ``q @ k^T`` and ``@ v``: the control's
lower precision), and returns the signature ``norm(x)[:, 0]``.

Departures from vit.py: seeded weights (``make_weights``: every linear's
and the patch projection's weight N(0, 1 / fan_in), their biases and the
CLS, position and time embeddings N(0, 0.02^2), LayerNorm weight 1 and
bias 0, ``temporal_fc`` drawn in every block; one draw on the card from a
``torch.Generator``), not the Kinetics-400 checkpoint; dense weights [in,
out], the patch projection HWIO; no dropout or drop path, no
interpolation of the embeddings. ``sample_indices`` and ``normalize`` are
PySlowFast's test-time input (``temporal_sampling``'s linspace over the
whole segment; ``/ 255``, mean 0.45, std 0.225), with one center crop.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
MEAN, STD = 0.45, 0.225
_NORMS = ("temporal_norm1", "norm1", "norm2")
_LINEARS = ("temporal_attn/qkv", "temporal_attn/proj", "temporal_fc", "attn/qkv",
            "attn/proj", "mlp/fc1", "mlp/fc2")


def layer_shapes(config: dict, channels: int = 3) -> list[tuple[str, str, tuple]]:
    """Every parameter of the configuration in order: (layer, key, shape)."""
    d, m, p = config["embed_dim"], config["mlp_dim"], config["patch_size"]
    patches = (config["crop_size"] // p) ** 2
    out = [("patch_embed", "w", (p, p, channels, d)), ("patch_embed", "b", (d,)),
           ("embed", "cls", (d,)), ("embed", "pos", (1 + patches, d)),
           ("embed", "time", (config["num_frames"], d))]
    widths = {"temporal_attn/qkv": (d, 3 * d), "temporal_attn/proj": (d, d),
              "temporal_fc": (d, d), "attn/qkv": (d, 3 * d), "attn/proj": (d, d),
              "mlp/fc1": (d, m), "mlp/fc2": (m, d)}
    for i in range(config["depth"]):
        for name in _NORMS:
            out += [(f"blocks/{i}/{name}", "w", (d,)), (f"blocks/{i}/{name}", "b", (d,))]
        for name in _LINEARS:
            out += [(f"blocks/{i}/{name}", "w", widths[name]),
                    (f"blocks/{i}/{name}", "b", (widths[name][1],))]
    return out + [("norm", "w", (d,)), ("norm", "b", (d,))]


def make_weights(generator: torch.Generator, config: dict, device) -> dict:
    """{layer: {key: f32 tensor}}: one normal draw for every parameter,
    scaled as the module docstring says."""
    shapes = layer_shapes(config)
    sizes = [math.prod(s) for _l, _k, s in shapes]
    z = torch.randn(sum(sizes), generator=generator, device=device)
    out: dict[str, dict[str, torch.Tensor]] = {}
    off = 0
    for (layer, key, shape), size in zip(shapes, sizes):
        if layer.split("/")[-1] in _NORMS + ("norm",):
            t = torch.full(shape, 1.0 if key == "w" else 0.0, device=device)
        elif key == "w" and layer != "embed":
            t = z[off:off + size].reshape(shape) / math.sqrt(math.prod(shape[:-1]))
        else:
            t = z[off:off + size].reshape(shape) * 0.02
        out.setdefault(layer, {})[key] = t
        off += size
    return out


def sample_indices(frame_cnt: int, num_samples: int) -> torch.Tensor:
    """PySlowFast's ``temporal_sampling`` over a whole segment:
    ``linspace(0, frame_cnt - 1, num_samples)``, clamped, truncated."""
    index = torch.linspace(0, frame_cnt - 1, num_samples)
    return torch.clamp(index, 0, frame_cnt - 1).long()


def normalize(rgb: torch.Tensor) -> torch.Tensor:
    """Resized and cropped BGR frames [..., 3] in [0, 255] -> RGB,
    (x / 255 - 0.45) / 0.225."""
    return (rgb.flip(-1).float() / 255.0 - MEAN) / STD


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _linear(w: dict, layer: str, x: torch.Tensor, cast) -> torch.Tensor:
    return cast(x) @ cast(w[layer]["w"]) + w[layer]["b"]


def _norm(w: dict, layer: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[layer]["w"], w[layer]["b"], LN_EPS)


def attention(w: dict, layer: str, x: torch.Tensor, heads: int, cast=_same) -> torch.Tensor:
    """vit.py's ``Attention.forward`` on x [B, N, C]."""
    b, n, c = x.shape
    qkv = _linear(w, f"{layer}/qkv", x, cast).reshape(b, n, 3, heads, c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (cast(q) @ cast(k).transpose(-2, -1)) * (c // heads) ** -0.5
    attn = attn.softmax(dim=-1)
    x = (cast(attn) @ cast(v)).transpose(1, 2).reshape(b, n, c)
    return _linear(w, f"{layer}/proj", x, cast)


def block(w: dict, i: int, x: torch.Tensor, t: int, heads: int, cast=_same) -> torch.Tensor:
    """vit.py's ``Block.forward`` (divided_space_time) on x [B, 1 + N T, C]."""
    pre = f"blocks/{i}"
    b, tokens, m = x.shape
    n = (tokens - 1) // t
    # Temporal
    xt = x[:, 1:, :]
    xt = xt.reshape(b * n, t, m)                                # 'b (h w t) m -> (b h w) t m'
    res_temporal = attention(w, f"{pre}/temporal_attn", _norm(w, f"{pre}/temporal_norm1", xt),
                             heads, cast)
    res_temporal = res_temporal.reshape(b, n * t, m)            # '(b h w) t m -> b (h w t) m'
    res_temporal = _linear(w, f"{pre}/temporal_fc", res_temporal, cast)
    xt = x[:, 1:, :] + res_temporal
    # Spatial
    init_cls_token = x[:, 0, :].unsqueeze(1)
    cls_token = init_cls_token.repeat(1, t, 1)
    cls_token = cls_token.reshape(b * t, m).unsqueeze(1)        # 'b t m -> (b t) m'
    xs = xt
    xs = xs.reshape(b, n, t, m).permute(0, 2, 1, 3).reshape(b * t, n, m)
    #                                                           'b (h w t) m -> (b t) (h w) m'
    xs = torch.cat((cls_token, xs), 1)
    res_spatial = attention(w, f"{pre}/attn", _norm(w, f"{pre}/norm1", xs), heads, cast)
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
    h = F.gelu(_linear(w, f"{pre}/mlp/fc1", _norm(w, f"{pre}/norm2", x), cast))
    return x + _linear(w, f"{pre}/mlp/fc2", h, cast)


def embed_tokens(w: dict, x: torch.Tensor, cast=_same) -> torch.Tensor:
    """vit.py's ``forward_features`` up to the blocks: RGB volumes [B, T, H,
    W, 3] -> tokens [B, 1 + N T, C]."""
    b, t = x.shape[:2]
    pw = w["patch_embed"]["w"]                                  # HWIO
    x = x.permute(0, 1, 4, 2, 3).reshape((b * t,) + (x.shape[4], x.shape[2], x.shape[3]))
    #                                                           'b c t h w -> (b t) c h w'
    x = F.conv2d(cast(x), cast(pw.permute(3, 2, 0, 1)), w["patch_embed"]["b"],
                 stride=pw.shape[0])
    x = x.flatten(2).transpose(1, 2)                            # [(b t), n, c]
    cls_tokens = w["embed"]["cls"].expand(x.size(0), 1, -1)
    x = torch.cat((cls_tokens, x), dim=1)
    x = x + w["embed"]["pos"]
    cls_tokens = x[:b, 0, :].unsqueeze(1)
    x = x[:, 1:]
    n, m = x.shape[1:]
    x = x.reshape(b, t, n, m).permute(0, 2, 1, 3).reshape(b * n, t, m)
    #                                                           '(b t) n m -> (b n) t m'
    x = x + w["embed"]["time"]
    x = x.reshape(b, n * t, m)                                  # '(b n) t m -> b (n t) m'
    return torch.cat((cls_tokens, x), dim=1)


@torch.no_grad()
def embed(w: dict, x: torch.Tensor, heads: int, cast=None) -> torch.Tensor:
    """RGB volumes [B, T, H, W, 3] -> f32 [B, C], in float32 (TF32 off)."""
    cast = cast or _same
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        t = x.shape[1]
        x = embed_tokens(w, x.float(), cast)
        depth = sum(1 for layer in w if layer.endswith("/mlp/fc1"))
        for i in range(depth):
            x = block(w, i, x, t, heads, cast)
        return _norm(w, "norm", x)[:, 0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
