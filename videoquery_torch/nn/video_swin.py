"""Video Swin Transformer (Swin-B), as a PyTorch module.

Liu, Ning, Cao, Wei, Zhang, Lin & Hu, "Video Swin Transformer", CVPR 2022
(arXiv:2106.13230), as ``github.com/SwinTransformer/Video-Swin-Transformer``'s
``mmaction/models/backbones/swin_transformer.py`` builds
``SwinTransformer3D`` for ``swin_base_patch244_window877_kinetics400_22k``:
a (2, 4, 4) patch projection to 128 channels and its LayerNorm, then four
stages of [2, 2, 18, 2] blocks with [4, 8, 16, 32] heads of 32 over
windows of (8, 7, 7) tokens, a PatchMerging after each of the first three,
an MLP of ratio 4, qkv biases, scale 32^-0.5, exact (erf) GELU, LayerNorm
eps 1e-5; the final LayerNorm over 1,024 channels and the head's mean over
(D, H, W).

A block of a stage whose tokens are [D, H, W] (``get_window_size``: a dim
no larger than the window takes the dim as its window and no shift; the
shift of odd blocks is half the window): ``x += proj(W-MSA(roll(pad(
norm1(x)), -s)))`` over windows, each window and head's logits ``q k^T *
32^-0.5 + B_rel (+ M)`` where ``B_rel`` is the block's relative position
bias table at ``relative_position_index[:N, :N]`` and ``M`` the published
``compute_mask`` (-100 between tokens of different regions of a shifted
window); then ``x += fc2(GELU(fc1(norm2(x))))``.

The residual stream is held as the published code holds it, [B, D, H, W,
C]. The pad, the roll and the window partition of a block are one row
gather (``window_rows``: each row of the windowed layout's source token,
or a zero row where it is pad), and the window reverse, the roll back and
the unpad are one gather of the attention's rows back into token order,
added to the stream in place. The windowed rows are in (view, position in
window, window) order, and the qkv weight's columns are held in (head,
q/k/v, channel) order, so each block's attention is one call of
``kernels/window_attention.py::window_attention`` on qkv's output as it
lies, which returns the rows ``proj`` reads. On the card that is one
launch of the hand-written kernel W1, which computes each logit's bias
from the block's table and its shift mask from the windows' region ids:
no [N, N] tensor is built. On the CPU it is the plain version beside the
kernel, ``window_attention_reference``, on the block's ``bias_geometry``:
the bias and mask [windows * heads, 1, N, N] built in float32 from
``relative_position_index`` and ``region_mask``, rounded once, and SDPA on
the math path. The net runs in the dtype of its input, float32 or
bfloat16: the linears are ``torch.addmm`` (cuBLAS on the card: bf16
operands, float32 sums), LayerNorm's statistics and the softmax are
computed in float32. The working-type weights and each block's bias table
(float32, transposed so a head's rows lie together) are built once and
cached, dropped when a parameter changes.

The parameter tree is the port's public layout (``make_weights``): dense
weights [in, out], the patch projection DHWIO [2, 4, 4, 3, 128], one entry
a layer named after the published modules
(``layers/<i>/blocks/<j>/attn/qkv``, ``layers/<i>/downsample/reduction``
...), each block's ``relative_position_bias_table`` [2535, heads] under
``layers/<i>/blocks/<j>/attn``, the Kinetics-400 head under ``cls_head``.

Spans (``core/profiling.py``), each with device events: ``videoswin.embed``
(the patch projection and its norm); in each block one ``videoswin.attn``
(norm1, the gathers, qkv, the attention, proj and the residual add), with
``videoswin.sdpa`` around the attention call alone, and one
``videoswin.mlp``; ``videoswin.merge`` around each PatchMerging. Inside
them, around the glue between the products and with no device events (only
their ``vq.*`` ranges, which a device trace attributes the launches to):
``videoswin.norm`` around each LayerNorm call (the embedding's, norm1,
norm2, each merge's and the final norm: 1 + 24 + 24 + 3 + 1 = 53 a forward
at the published depths, the last one inside the caller's span),
``videoswin.add`` around each residual add alone (48), and
``videoswin.window_gather`` around each block's gather into windows (with
the zero row's pad) and its gather back (48). Counters:
``videoswin.sdpa_calls`` (24 a forward), ``videoswin.shifted_calls`` (the
calls under a shift mask: 12 a forward at the published sizes),
``videoswin.window_attn_launches`` (W1's launches: 24 a forward on the
card, 0 on the CPU) and ``videoswin.views`` (the volumes embedded).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videoquery_torch.core.profiling import count, span
from videoquery_torch.kernels import window_attention as w1

EMBED_DIM = 128
DEPTHS = (2, 2, 18, 2)
HEADS = (4, 8, 16, 32)
WINDOW = (8, 7, 7)
PATCH = (2, 4, 4)
MLP_RATIO = 4
CLIP_LEN = 32
CROP = 224
NUM_CLASSES = 400        # Kinetics-400
RGB_CHANNELS = 3         # RGB, ImageNet mean and std
LN_EPS = 1e-5
MASK_VALUE = -100.0      # compute_mask's fill between regions
PATCH_EMBED = "patch_embed/proj"
HEAD = "cls_head/fc_cls"
TABLE = "relative_position_bias_table"

# PatchMerging's (h, w) offsets in the order it concatenates them: x0 (0, 0),
# x1 (1, 0), x2 (0, 1), x3 (1, 1)
MERGE_OFFSETS = ((0, 0), (1, 0), (0, 1), (1, 1))


def stage_dims(depths=DEPTHS, embed_dim: int = EMBED_DIM) -> list[int]:
    """Each stage's channels: the embedding's, doubled by each merge."""
    return [embed_dim * 2 ** i for i in range(len(depths))]


def layer_shapes(embed_dim: int = EMBED_DIM, depths=DEPTHS, heads=HEADS, window=WINDOW,
                 patch=PATCH, channels: int = RGB_CHANNELS,
                 num_classes: int = NUM_CLASSES) -> list[tuple[str, str, tuple]]:
    """Every parameter in order: (layer, key, shape)."""
    out = [(PATCH_EMBED, "w", tuple(patch) + (channels, embed_dim)),
           (PATCH_EMBED, "b", (embed_dim,)),
           ("patch_embed/norm", "w", (embed_dim,)), ("patch_embed/norm", "b", (embed_dim,))]
    rows = math.prod(2 * w - 1 for w in window)
    dims = stage_dims(depths, embed_dim)
    for i, (depth, h, c) in enumerate(zip(depths, heads, dims)):
        for j in range(depth):
            pre = f"layers/{i}/blocks/{j}"
            out += [(f"{pre}/norm1", "w", (c,)), (f"{pre}/norm1", "b", (c,)),
                    (f"{pre}/attn", TABLE, (rows, h)),
                    (f"{pre}/attn/qkv", "w", (c, 3 * c)), (f"{pre}/attn/qkv", "b", (3 * c,)),
                    (f"{pre}/attn/proj", "w", (c, c)), (f"{pre}/attn/proj", "b", (c,)),
                    (f"{pre}/norm2", "w", (c,)), (f"{pre}/norm2", "b", (c,)),
                    (f"{pre}/mlp/fc1", "w", (c, MLP_RATIO * c)),
                    (f"{pre}/mlp/fc1", "b", (MLP_RATIO * c,)),
                    (f"{pre}/mlp/fc2", "w", (MLP_RATIO * c, c)), (f"{pre}/mlp/fc2", "b", (c,))]
        if i + 1 < len(depths):
            out += [(f"layers/{i}/downsample/norm", "w", (4 * c,)),
                    (f"layers/{i}/downsample/norm", "b", (4 * c,)),
                    (f"layers/{i}/downsample/reduction", "w", (4 * c, 2 * c))]
    out += [("norm", "w", (dims[-1],)), ("norm", "b", (dims[-1],)),
            (HEAD, "w", (dims[-1], num_classes)), (HEAD, "b", (num_classes,))]
    return out


def _is_norm(layer: str) -> bool:
    return layer.split("/")[-1] in ("norm", "norm1", "norm2")


def make_weights(seed: int, channels: int = RGB_CHANNELS, embed_dim: int = EMBED_DIM,
                 depths=DEPTHS, heads=HEADS, window=WINDOW, patch=PATCH,
                 num_classes: int = NUM_CLASSES) -> dict[str, dict[str, np.ndarray]]:
    """Seeded parameters from numpy's generator: every linear's and the
    patch projection's weight N(0, 1 / fan_in), so attention logits have
    about unit spread; their biases N(0, 0.02^2); LayerNorm weight 1, bias
    0; each ``relative_position_bias_table`` N(0, 1) (the published
    trunc-normal 0.02 would hide the bias from every check)."""
    rng = np.random.default_rng(int(seed))
    params: dict[str, dict[str, np.ndarray]] = {}
    for layer, key, shape in layer_shapes(embed_dim, depths, heads, window, patch, channels,
                                          num_classes):
        if _is_norm(layer):
            a = np.ones(shape) if key == "w" else np.zeros(shape)
        elif key == TABLE:
            a = rng.standard_normal(shape)
        elif key == "w":
            a = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        else:
            a = rng.standard_normal(shape) * 0.02
        params.setdefault(layer, {})[key] = a.astype(np.float32)
    return params


def _key(layer: str, key: str) -> str:
    return f"{layer}/{key}".replace("/", "__")


def _rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[:, index]`` of a contiguous x [B, L, C], each row moved as 8-byte
    words where its bytes allow (the gather kernel moves one element a
    thread: a 2-byte element is a third of the speed)."""
    if x.shape[-1] * x.element_size() % 8:
        return x[:, index]
    return torch.index_select(x.view(torch.int64), 1, index).view(x.dtype)


# -- window geometry (numpy, built once a shape) ------------------------------

def get_window_size(dims, window, shift):
    """The published ``get_window_size``: a dim no larger than the window
    takes the dim as its window and no shift."""
    use_window, use_shift = list(window), list(shift)
    for i, n in enumerate(dims):
        if n <= window[i]:
            use_window[i] = n
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


def relative_position_index(window) -> np.ndarray:
    """[N, N] rows of the bias table for a window of N = prod(window)
    tokens: (dd + wd - 1) (2wh - 1)(2ww - 1) + (dh + wh - 1)(2ww - 1) + dw + ww - 1
    for the 3D offset (dd, dh, dw) of token i from token j."""
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in window], indexing="ij")).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (np.asarray(window) - 1)[:, None, None]
    return (rel[0] * (2 * window[1] - 1) * (2 * window[2] - 1)
            + rel[1] * (2 * window[2] - 1) + rel[2])


def region_mask(padded, window, shift) -> np.ndarray:
    """The published ``compute_mask``: [windows, N, N] of 0 where two
    tokens of a window lie in one region of the shifted grid, MASK_VALUE
    where not."""
    img = np.zeros(padded, np.int64)
    cnt = 0
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(window, shift)]
    for d in cuts[0]:
        for h in cuts[1]:
            for w in cuts[2]:
                img[d, h, w] = cnt
                cnt += 1
    (nd, nh, nw), (wd, wh, ww) = [p // w for p, w in zip(padded, window)], window
    windows = img.reshape(nd, wd, nh, wh, nw, ww).transpose(0, 2, 4, 1, 3, 5)
    windows = windows.reshape(nd * nh * nw, wd * wh * ww)
    return np.where(windows[:, None, :] != windows[:, :, None], MASK_VALUE, 0.0)


def bias_geometry(dims, window, shift, table_window) -> tuple[np.ndarray, np.ndarray | None]:
    """The plain attention's geometry of a block on tokens ``dims`` with
    its clamped ``window`` and ``shift``: the bias table's rows [N, N]
    (``relative_position_index(table_window)[:N, :N]``) and the shift mask
    [windows, N, N] (``region_mask``; None where the block does not
    shift)."""
    n = math.prod(window)
    padded = [-(-d // w) * w for d, w in zip(dims, window)]
    mask = region_mask(padded, window, shift) if any(shift) else None
    return relative_position_index(table_window)[:n, :n], mask


def window_rows(dims, window, shift) -> tuple[np.ndarray, np.ndarray, int]:
    """The gathers of one view's block on tokens [D, H, W] in (d, h, w)
    order: ``src`` [N * windows], each windowed row's source token (row
    ``n * windows + w`` holds position n of window w of ``roll(pad(x), -s)``;
    a pad position reads token D * H * W, the zero row), ``back`` [D * H *
    W], each token's windowed row, and the number of windows."""
    padded = [-(-n // w) * w for n, w in zip(dims, window)]
    grid = np.stack(np.meshgrid(*[np.arange(p) for p in padded], indexing="ij"))
    # roll(x, -s)[p] = x[(p + s) mod padded]
    source = [(grid[i] + shift[i]) % padded[i] for i in range(3)]
    real = (source[0] < dims[0]) & (source[1] < dims[1]) & (source[2] < dims[2])
    token = np.where(real, (source[0] * dims[1] + source[1]) * dims[2] + source[2],
                     math.prod(dims))
    (nd, nh, nw), (wd, wh, ww) = [p // w for p, w in zip(padded, window)], window
    # (window, position) -> (position, window)
    token = token.reshape(nd, wd, nh, wh, nw, ww).transpose(1, 3, 5, 0, 2, 4).reshape(-1)
    back = np.empty(math.prod(dims), np.int64)
    rows = np.flatnonzero(token < math.prod(dims))
    back[token[rows]] = rows
    return token, back, nd * nh * nw


class VideoSwin(nn.Module):
    """Video Swin Transformer (module docstring). ``embed`` takes RGB
    volumes ``[N, T, H, W, 3]``, float32 or bfloat16, and returns float32
    ``[N, C]``, the mean over (D, H, W) of the final norm."""

    # embed takes a segment's volume [N, T, H, W, C], not images
    temporal = True

    def __init__(self, params: dict[str, dict], window=WINDOW):
        super().__init__()
        self.params = nn.ParameterDict()
        for layer, leaf in params.items():
            for key, a in leaf.items():
                self.params[_key(layer, key)] = nn.Parameter(
                    torch.as_tensor(a, dtype=torch.float32), requires_grad=False)
        proj = self.params[_key(PATCH_EMBED, "w")]
        self.patch = tuple(proj.shape[:3])
        self.embed_dim = proj.shape[-1]
        self.depths, self.heads = [], []
        while _key(f"layers/{len(self.depths)}/blocks/0/norm1", "w") in self.params:
            i = len(self.depths)
            self.depths.append(sum(1 for k in self.params
                                   if k.startswith(f"layers__{i}__blocks__")
                                   and k.endswith("__norm1__w")))
            self.heads.append(self.params[_key(f"layers/{i}/blocks/0/attn", TABLE)].shape[1])
        self.window = tuple(window)
        rows = math.prod(2 * w - 1 for w in self.window)
        if self.params[_key("layers/0/blocks/0/attn", TABLE)].shape[0] != rows:
            raise ValueError(f"the bias tables do not fit a window of {self.window}")
        # the weights in a working type and the blocks' bias tables by
        # (dtype, device); dropped when a parameter's storage or version
        # changes
        self._cast: dict[tuple, dict] = {}
        self._cache_stamp: tuple | None = None
        # window geometry by (dims, window, shift), on each device
        self._geometries: dict[tuple, tuple] = {}

    def _weights(self, x: torch.Tensor) -> dict:
        """Every parameter in x's dtype and on its device, the patch
        projection as a [prod(patch) * C_in, C] matrix, each qkv weight and
        bias with its columns in (head, q/k/v, channel) order, and each
        block's bias table in float32, transposed so a head's rows lie
        together."""
        stamp = tuple((p.data_ptr(), p._version) for p in self.params.values())
        if stamp != self._cache_stamp:
            self._cast.clear()
            self._cache_stamp = stamp
        cast = self._cast.get((x.dtype, x.device))
        if cast is None:
            p = {k: v.detach().to(x.device) for k, v in self.params.items()}
            cast = {k: v.to(x.dtype) for k, v in p.items()}
            w = p[_key(PATCH_EMBED, "w")]
            cast["patch_w"] = w.reshape(-1, w.shape[-1]).to(x.dtype)
            cast["tables"] = {}
            for i, (depth, h) in enumerate(zip(self.depths, self.heads)):
                for j in range(depth):
                    table = p[_key(f"layers/{i}/blocks/{j}/attn", TABLE)]
                    cast["tables"][f"layers/{i}/blocks/{j}/attn"] = table.t().contiguous().t()
                    name = f"layers/{i}/blocks/{j}/attn/qkv"
                    qw, qb = p[_key(name, "w")], p[_key(name, "b")]
                    c = qw.shape[0]
                    cast[_key(name, "w")] = qw.view(c, 3, h, c // h).permute(0, 2, 1, 3) \
                        .reshape(c, 3 * c).to(x.dtype)
                    cast[_key(name, "b")] = qb.view(3, h, c // h).permute(1, 0, 2) \
                        .reshape(3 * c).to(x.dtype)
            self._cast[(x.dtype, x.device)] = cast
        return cast

    def _geometry(self, dims, shift, device) -> tuple:
        """(window, shift, src, back) of a block on tokens ``dims`` with the
        block's nominal ``shift``, the gathers on ``device``."""
        key = (tuple(dims), tuple(shift), device)
        if key not in self._geometries:
            window, use_shift = get_window_size(dims, self.window, shift)
            src, back, _windows = window_rows(dims, window, use_shift)
            self._geometries[key] = (window, use_shift, torch.from_numpy(src).to(device),
                                     torch.from_numpy(back).to(device))
        return self._geometries[key]

    def _linear(self, w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        """x [..., in] @ W + b -> [M, out] (x's rows flattened)."""
        return torch.addmm(w[_key(name, "b")], x.reshape(-1, x.shape[-1]), w[_key(name, "w")])

    @staticmethod
    def _norm(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        with span("videoswin.norm"):
            return F.layer_norm(x, (x.shape[-1],), w[_key(name, "w")], w[_key(name, "b")],
                                LN_EPS)

    def _attn(self, w: dict, i: int, j: int, x: torch.Tensor) -> None:
        """Block j of stage i, its attention half, on x [B, D, H, W, C] in
        place: x += W-MSA of norm1(x), shifted in odd blocks."""
        b, dims, c = x.shape[0], x.shape[1:4], x.shape[4]
        pre = f"layers/{i}/blocks/{j}"
        nominal = tuple(ws // 2 for ws in self.window) if j % 2 else (0, 0, 0)
        with span("videoswin.attn", x.device):
            window, shift, src, back = self._geometry(dims, nominal, x.device)
            tokens = math.prod(dims)
            z = self._norm(w, f"{pre}/norm1", x).view(b, tokens, c)
            with span("videoswin.window_gather"):
                if src.numel() > tokens:
                    z = F.pad(z, (0, 0, 0, 1))                          # the zero row
                zw = _rows(z, src)                                      # [B, N * nW, C]
            qkv = self._linear(w, f"{pre}/attn/qkv", zw)                # (head, qkv, ch) cols
            launches = w1.LAUNCHES
            table = w["tables"][f"{pre}/attn"]
            with span("videoswin.sdpa", x.device):                      # (view, pos, window) rows
                if qkv.is_cuda:
                    rows = w1.window_attention(qkv, table, b, dims, window, shift, self.window)
                else:
                    rows = w1.window_attention_reference(
                        qkv, table, b, *bias_geometry(dims, window, shift, self.window))
            count("videoswin.sdpa_calls")
            count("videoswin.window_attn_launches", w1.LAUNCHES - launches)
            if any(shift):
                count("videoswin.shifted_calls")
            y = self._linear(w, f"{pre}/attn/proj", rows).view(b, -1, c)
            with span("videoswin.window_gather"):
                y = _rows(y, back)
            with span("videoswin.add"):
                x.view(b, tokens, c).add_(y)

    def _mlp(self, w: dict, i: int, j: int, x: torch.Tensor) -> None:
        """Block j of stage i, its MLP half, on x in place."""
        pre = f"layers/{i}/blocks/{j}"
        with span("videoswin.mlp", x.device):
            h = F.gelu(self._linear(w, f"{pre}/mlp/fc1", self._norm(w, f"{pre}/norm2", x)))
            y = self._linear(w, f"{pre}/mlp/fc2", h)
            with span("videoswin.add"):
                x.view(-1, x.shape[-1]).add_(y)

    def _merge(self, w: dict, i: int, x: torch.Tensor) -> torch.Tensor:
        """PatchMerging after stage i: x [B, D, H, W, C] -> [B, D, H/2, W/2,
        2C] (H and W padded to even), its 2x2 neighbours concatenated in
        MERGE_OFFSETS' order, LayerNorm(4C), the reduction (no bias)."""
        with span("videoswin.merge", x.device):
            h, wd = x.shape[2], x.shape[3]
            if h % 2 or wd % 2:
                x = F.pad(x, (0, 0, 0, wd % 2, 0, h % 2))
            x = torch.cat([x[:, :, dh::2, dw::2] for dh, dw in MERGE_OFFSETS], -1)
            z = self._norm(w, f"layers/{i}/downsample/norm", x)
            out = z.reshape(-1, z.shape[-1]) @ w[_key(f"layers/{i}/downsample/reduction", "w")]
            return out.view(x.shape[:4] + (out.shape[-1],))

    def _embed_tokens(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        """RGB volumes [B, T, H, W, 3] -> tokens [B, T/2, H/4, W/4, C]: the
        (2, 4, 4) patch projection (the volume padded at its ends to whole
        patches) and its LayerNorm."""
        pd, ph, pw = self.patch
        with span("videoswin.embed", x.device):
            t, h, wd = x.shape[1:4]
            if t % pd or h % ph or wd % pw:
                x = F.pad(x, (0, 0, 0, -wd % pw, 0, -h % ph, 0, -t % pd))
            b, t, h, wd, c = x.shape
            rows = x.reshape(b, t // pd, pd, h // ph, ph, wd // pw, pw, c) \
                .permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, pd * ph * pw * c)
            emb = torch.addmm(w[_key(PATCH_EMBED, "b")], rows, w["patch_w"])
            emb = self._norm(w, "patch_embed/norm", emb)
        return emb.view(b, t // pd, h // ph, wd // pw, self.embed_dim)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, head: bool = True) -> dict[str, torch.Tensor]:
        """[N, T, H, W, 3] x -> {'global_pool': f32 [N, C], the mean over
        (D, H, W) of the final norm; 'logits': f32 [N, classes]} (the
        logits only with the head)."""
        w = self._weights(x)
        count("videoswin.views", x.shape[0])
        tokens = self._embed_tokens(w, x)
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                self._attn(w, i, j, tokens)
                self._mlp(w, i, j, tokens)
            if i + 1 < len(self.depths):
                tokens = self._merge(w, i, tokens)
        feats = self._norm(w, "norm", tokens).flatten(1, 3).float().mean(1)
        out = {"global_pool": feats}
        if head:
            out["logits"] = feats @ self.params[_key(HEAD, "w")] + self.params[_key(HEAD, "b")]
        return out

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 signature of each volume of x [N, T, H, W, 3]."""
        return self.forward(x, head=False)["global_pool"]
