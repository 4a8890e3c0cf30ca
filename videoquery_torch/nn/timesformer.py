"""TimeSformer with divided space-time attention, as a PyTorch module.

Bertasius, Wang & Torresani, "Is Space-Time Attention All You Need for
Video Understanding?", ICML 2021 (arXiv:2102.05095), as
``github.com/facebookresearch/TimeSformer``'s ``timesformer/models/vit.py``
builds ``VisionTransformer`` with ``attention_type='divided_space_time'``,
at the widths of ``TimeSformer_divST_96x4_224`` (TimeSformer-L): ViT-B/16,
12 blocks of hidden size 768, 12 heads of 64, an MLP of 3072, qkv biases,
LayerNorm eps 1e-6, exact (erf) GELU, 96 frames of 224x224.

A segment of T frames is T x N patch tokens (N = (224 / 16)^2 = 196) and
one CLS token. The embedding: a 16x16/16 patch projection of each frame,
``pos_embed[1:]`` added to each frame's patches and ``time_embed[t]`` to
each patch token; the CLS token is ``cls_token + pos_embed[0]``. A block
(``x`` = [CLS; patch tokens], the patches in (h, w, t) order):

1. time: ``x_p += temporal_fc(temporal_attn(temporal_norm1(x_p)))``, the
   attention over the T frames of each patch site;
2. space: each frame's ``[CLS; x_p of that frame]`` (1 + N tokens) through
   ``r = attn(norm1(.))``; the CLS token gains the mean over the frames of
   its T rows ``r[0]``, the patches their own rows;
3. ``x += fc2(GELU(fc1(norm2(x))))``.

The signature is ``norm(x)[CLS]``, the 768-d output of ``forward_features``.

The residual stream is held as vit.py holds it, [B, 1 + N * T, D] with the
patches in (h, w, t) order, so the time attention reads its [B * N, T, D]
groups as a view and only the space attention moves tokens: its [B * T,
1 + N, D] input holds each frame's CLS row and patches, and its result is
added back in (h, w, t) order. Each step's residual add and the next
step's LayerNorm are one call of N1 (``kernels/add_norm.py``: the kernel on
the card, its plain version, the op chain of ``add_``, ``mean``,
``torch.cat`` and ``F.layer_norm``, on the CPU), which writes the LayerNorm
in the row order the next step reads: 3 x depth - 1 calls a forward (block
0's ``temporal_norm1`` follows the embedding and is ``F.layer_norm``; the
last MLP's output is added in place before the final norm). The net runs
in the dtype of its input, float32 or bfloat16: the linears are
``torch.addmm`` (cuBLAS on the card: bf16 operands, float32 sums, the bias
added before the one rounding), LayerNorm's statistics and the softmax
are computed in float32, and each attention is one
``F.scaled_dot_product_attention`` call with the published scale 64^-0.5.
On the card every attention call runs under ``sdpa_kernel`` limited to the
fused backends (flash, cuDNN, memory-efficient): where none of them takes
an input, the call raises instead of falling to the math path. On the CPU
the math path is allowed. The working-type weights are cast once and
cached, dropped when a parameter changes.

The parameter tree is the port's public layout (``make_weights``): dense
weights [in, out], the patch projection HWIO [16, 16, 3, D], the embeddings
under ``embed`` (``cls`` [D], ``pos`` [1 + N, D], ``time`` [T, D]), one
entry a layer named after vit.py's modules (``blocks/<i>/temporal_attn/qkv``
...), the Kinetics-400 head under ``head``.

Spans (``core/profiling.py``), each with device events: ``timesformer.embed``
(the patch projection and the embeddings), and in each of the blocks one
``timesformer.time_attn``, one ``timesformer.space_attn`` and one
``timesformer.mlp``, each opened by the N1 call that completes the step
before's residual add and writes the step's LayerNorm in its layout (block
0's time step: its LayerNorm alone; the last MLP also holds its own add);
inside each N1 call's step span ``timesformer.add_norm`` around that call
alone, and inside the two attention spans ``timesformer.sdpa`` around the
attention call alone. The counter ``timesformer.sdpa_calls`` counts the
attention calls: 2 a block, 24 a forward; ``timesformer.add_norm_launches``
N1's kernel launches: 35 a forward on the card, 0 on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from videoquery_torch.core.profiling import count, span
from videoquery_torch.kernels import add_norm

DIM = 768
DEPTH = 12
HEADS = 12
MLP_DIM = 3072
PATCH = 16
NUM_FRAMES = 96
CROP = 224
NUM_CLASSES = 400        # Kinetics-400
RGB_CHANNELS = 3         # RGB, (x / 255 - 0.45) / 0.225
LN_EPS = 1e-6
EMBED = "embed"
HEAD = "head"

# the backends an attention call may take on the card
FUSED_SDPA = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION]

# (layer, key) of a block's LayerNorms and linears, vit.py's module names
_BLOCK_LINEARS = ("temporal_attn/qkv", "temporal_attn/proj", "temporal_fc", "attn/qkv",
                  "attn/proj", "mlp/fc1", "mlp/fc2")
_BLOCK_NORMS = ("temporal_norm1", "norm1", "norm2")


def layer_shapes(depth: int = DEPTH, dim: int = DIM, mlp_dim: int = MLP_DIM,
                 frames: int = NUM_FRAMES, patches: int = (CROP // PATCH) ** 2,
                 patch: int = PATCH, channels: int = RGB_CHANNELS,
                 num_classes: int = NUM_CLASSES) -> list[tuple[str, str, tuple]]:
    """Every parameter in order: (layer, key, shape)."""
    out = [("patch_embed", "w", (patch, patch, channels, dim)), ("patch_embed", "b", (dim,)),
           (EMBED, "cls", (dim,)), (EMBED, "pos", (1 + patches, dim)),
           (EMBED, "time", (frames, dim))]
    widths = {"temporal_attn/qkv": (dim, 3 * dim), "temporal_attn/proj": (dim, dim),
              "temporal_fc": (dim, dim), "attn/qkv": (dim, 3 * dim), "attn/proj": (dim, dim),
              "mlp/fc1": (dim, mlp_dim), "mlp/fc2": (mlp_dim, dim)}
    for i in range(depth):
        for name in _BLOCK_NORMS:
            out += [(f"blocks/{i}/{name}", "w", (dim,)), (f"blocks/{i}/{name}", "b", (dim,))]
        for name in _BLOCK_LINEARS:
            fan_in, fan_out = widths[name]
            out += [(f"blocks/{i}/{name}", "w", (fan_in, fan_out)),
                    (f"blocks/{i}/{name}", "b", (fan_out,))]
    out += [("norm", "w", (dim,)), ("norm", "b", (dim,)),
            (HEAD, "w", (dim, num_classes)), (HEAD, "b", (num_classes,))]
    return out


def make_weights(seed: int, in_channels: int = RGB_CHANNELS, depth: int = DEPTH,
                 dim: int = DIM, mlp_dim: int = MLP_DIM, frames: int = NUM_FRAMES,
                 crop: int = CROP, patch: int = PATCH,
                 num_classes: int = NUM_CLASSES) -> dict[str, dict[str, np.ndarray]]:
    """Seeded parameters from numpy's generator: every linear's and the
    patch projection's weight N(0, 1 / fan_in), so attention logits have
    about unit spread; their biases and the CLS, position and time
    embeddings N(0, 0.02^2); LayerNorm weight 1, bias 0. ``temporal_fc`` is
    drawn like the other linears in every block (the published init zeroes
    it in blocks 1-11 for ImageNet warm starts, which would hide the time
    path from every check)."""
    rng = np.random.default_rng(int(seed))
    params: dict[str, dict[str, np.ndarray]] = {}
    for layer, key, shape in layer_shapes(depth, dim, mlp_dim, frames, (crop // patch) ** 2,
                                          patch, in_channels, num_classes):
        if layer.split("/")[-1] in _BLOCK_NORMS + ("norm",):
            a = np.ones(shape) if key == "w" else np.zeros(shape)
        elif key == "w" and layer != EMBED:
            fan_in = math.prod(shape[:-1])
            a = rng.standard_normal(shape) / math.sqrt(fan_in)
        else:
            a = rng.standard_normal(shape) * 0.02
        params.setdefault(layer, {})[key] = a.astype(np.float32)
    return params


def _key(layer: str, key: str) -> str:
    return f"{layer}/{key}".replace("/", "__")


class TimeSformer(nn.Module):
    """Divided space-time TimeSformer (module docstring). ``embed`` takes
    RGB volumes ``[N, T, H, W, 3]``, float32 or bfloat16, and returns
    float32 ``[N, D]``."""

    # embed takes a segment's volume [N, T, H, W, C], not images
    temporal = True

    def __init__(self, params: dict[str, dict], heads: int = HEADS):
        super().__init__()
        self.params = nn.ParameterDict()
        for layer, leaf in params.items():
            for key, a in leaf.items():
                self.params[_key(layer, key)] = nn.Parameter(
                    torch.as_tensor(a, dtype=torch.float32), requires_grad=False)
        self.dim = self.params[_key(EMBED, "cls")].shape[0]
        self.frames = self.params[_key(EMBED, "time")].shape[0]
        self.patches = self.params[_key(EMBED, "pos")].shape[0] - 1
        self.patch = self.params[_key("patch_embed", "w")].shape[0]
        self.depth = sum(1 for k in self.params if k.endswith("__mlp__fc1__w"))
        if self.dim % heads:
            raise ValueError(f"{heads} heads do not divide the width {self.dim}")
        self.heads = heads
        # the weights in a working type by (dtype, device); dropped when a
        # parameter's storage or version changes
        self._cast: dict[tuple, dict[str, torch.Tensor]] = {}
        self._cache_stamp: tuple | None = None

    def _weights(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """Every parameter in x's dtype and on its device, the patch
        projection as a [P * P * C, D] matrix, and the embeddings summed in
        float32 and rounded once: ``cls_row`` (cls + pos[0]) and ``table``
        [N, T, D] (pos[1:] at each patch site + time at each frame)."""
        stamp = tuple((p.data_ptr(), p._version) for p in self.params.values())
        if stamp != self._cache_stamp:
            self._cast.clear()
            self._cache_stamp = stamp
        cast = self._cast.get((x.dtype, x.device))
        if cast is None:
            p = {k: v.detach().to(x.device) for k, v in self.params.items()}
            cast = {k: v.to(x.dtype) for k, v in p.items()}
            w = p[_key("patch_embed", "w")]
            cast["patch_w"] = w.reshape(-1, w.shape[-1]).to(x.dtype)
            pos, time = p[_key(EMBED, "pos")], p[_key(EMBED, "time")]
            cast["cls_row"] = (p[_key(EMBED, "cls")] + pos[0]).to(x.dtype)
            cast["table"] = (pos[1:, None, :] + time[None, :, :]).to(x.dtype)
            self._cast[(x.dtype, x.device)] = cast
        return cast

    def _linear(self, w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        """x [..., in] @ W + b -> [M, out] (x's rows flattened)."""
        return torch.addmm(w[_key(name, "b")], x.reshape(-1, x.shape[-1]), w[_key(name, "w")])

    def _norm(self, w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (self.dim,), w[_key(name, "w")], w[_key(name, "b")], LN_EPS)

    def _attention(self, w: dict, name: str, z: torch.Tensor) -> torch.Tensor:
        """vit.py's ``Attention`` on z [S, L, D]: qkv, one SDPA call over
        [S, heads, L, D / heads] views of it, proj -> [S * L, D]."""
        s, length, d = z.shape
        qkv = self._linear(w, f"{name}/qkv", z).view(s, length, 3, self.heads, d // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        with span("timesformer.sdpa", z.device):
            o = F.scaled_dot_product_attention(q, k, v)
        count("timesformer.sdpa_calls")
        return self._linear(w, f"{name}/proj", o.transpose(1, 2).reshape(s * length, d))

    def _add_norm(self, w: dict, name: str, x: torch.Tensor, prev: torch.Tensor | None,
                  t: int, after: str) -> torch.Tensor:
        """N1 (``kernels/add_norm.py``): prev, the output of the step
        ``after``, added to x in place, and LayerNorm ``name`` of the new x
        in the layout the next step reads."""
        with span("timesformer.add_norm", x.device):
            launches = add_norm.LAUNCHES
            z = add_norm.add_norm(x, prev, w[_key(name, "w")], w[_key(name, "b")], t, after,
                                  LN_EPS)
            count("timesformer.add_norm_launches", add_norm.LAUNCHES - launches)
        return z

    @staticmethod
    def _residual(x: torch.Tensor, out: torch.Tensor, t: int, after: str,
                  defer: bool) -> torch.Tensor | None:
        """A step's output: returned for the next step's N1 to add (defer),
        or added to x now."""
        if defer:
            return out
        add_norm.residual_add(x, out, t, after)
        return None

    def _time_attn(self, w: dict, i: int, x: torch.Tensor, t: int,
                   prev: torch.Tensor | None = None, defer: bool = False):
        """Step 1 of block i on x [B, 1 + N * T, D]: the patch tokens attend
        over their site's T frames. ``prev``, block i - 1's fc2 output, is
        added by the N1 call that writes ``temporal_norm1``'s output; without
        it (block 0, after the embedding) that LayerNorm is ``F.layer_norm``.
        ``temporal_fc``'s output is added in place, or with ``defer``
        returned for the space step's N1."""
        d = x.shape[2]
        with span("timesformer.time_attn", x.device):
            name = f"blocks/{i}/temporal_norm1"
            z = (self._norm(w, name, x[:, 1:]) if prev is None
                 else self._add_norm(w, name, x, prev, t, "mlp"))
            a = self._attention(w, f"blocks/{i}/temporal_attn", z.view(-1, t, d))
            return self._residual(x, self._linear(w, f"blocks/{i}/temporal_fc", a), t, "time",
                                  defer)

    def _space_attn(self, w: dict, i: int, x: torch.Tensor, t: int,
                    prev: torch.Tensor | None = None, defer: bool = False):
        """Step 2 of block i on x: each frame's [CLS; patches] attend over
        the frame. N1 adds ``prev``, the time step's ``temporal_fc`` output
        (where given), and writes ``norm1``'s output in that layout. The
        attention's output is added in place (the CLS token gains the frame
        mean of its rows, the patches their own), or with ``defer`` returned
        for the MLP's N1."""
        b, tokens, d = x.shape
        n = (tokens - 1) // t
        with span("timesformer.space_attn", x.device):
            z = self._add_norm(w, f"blocks/{i}/norm1", x, prev, t, "time")  # [B, T, 1 + N, D]
            r = self._attention(w, f"blocks/{i}/attn", z.view(b * t, 1 + n, d))
            return self._residual(x, r, t, "space", defer)

    def _mlp(self, w: dict, i: int, x: torch.Tensor, t: int, prev: torch.Tensor,
             defer: bool = False):
        """Step 3 of block i on x: N1 adds ``prev``, the space attention's
        output, and writes ``norm2``'s output; fc2's output is added in
        place, or with ``defer`` returned for block i + 1's N1."""
        with span("timesformer.mlp", x.device):
            z = self._add_norm(w, f"blocks/{i}/norm2", x, prev, t, "space")
            h = F.gelu(self._linear(w, f"blocks/{i}/mlp/fc1", z))
            return self._residual(x, self._linear(w, f"blocks/{i}/mlp/fc2", h), t, "mlp", defer)

    def _embed_tokens(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        """RGB volumes [B, T, H, W, C] -> tokens [B, 1 + N * T, D], the
        patches in (h, w, t) order."""
        b, t, hh, ww, c = x.shape
        p = self.patch
        hp, wp = hh // p, ww // p
        if (t, hp * wp, hh % p, ww % p) != (self.frames, self.patches, 0, 0):
            raise ValueError(f"a volume of {t} frames of {hh}x{ww} does not fit {self.frames} "
                             f"frames of {self.patches} patches of {p}x{p}")
        with span("timesformer.embed", x.device):
            # each patch as a (kh, kw, c) row, the rows in (h, w, t) order
            rows = x.reshape(b, t, hp, p, wp, p, c).permute(0, 2, 4, 1, 3, 5, 6)
            emb = torch.addmm(w[_key("patch_embed", "b")], rows.reshape(-1, p * p * c),
                              w["patch_w"])
            tokens = torch.empty((b, 1 + hp * wp * t, self.dim), dtype=x.dtype, device=x.device)
            tokens[:, 0] = w["cls_row"]
            torch.add(emb.view(b, hp * wp, t, self.dim), w["table"],
                      out=tokens[:, 1:].view(b, hp * wp, t, self.dim))
        return tokens

    @torch.no_grad()
    def forward(self, x: torch.Tensor, head: bool = True) -> dict[str, torch.Tensor]:
        """[N, T, H, W, 3] x -> {'global_pool': f32 [N, D], the final norm's
        CLS row; 'logits': f32 [N, classes]} (the logits only with the
        head)."""
        w = self._weights(x)
        t = x.shape[1]
        backends = FUSED_SDPA if x.is_cuda else FUSED_SDPA + [SDPBackend.MATH]
        with sdpa_kernel(backends):
            tokens = self._embed_tokens(w, x)
            # each step's output is added by the next step's N1 call; the
            # last MLP's is added in place, before the final norm
            out = None
            for i in range(self.depth):
                out = self._time_attn(w, i, tokens, t, out, defer=True)
                out = self._space_attn(w, i, tokens, t, out, defer=True)
                out = self._mlp(w, i, tokens, t, out, defer=i + 1 < self.depth)
        emb = self._norm(w, "norm", tokens[:, 0]).float()
        out = {"global_pool": emb}
        if head:
            out["logits"] = emb @ self.params[_key(HEAD, "w")] + self.params[_key(HEAD, "b")]
        return out

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 signature of each volume of x [N, T, H, W, 3]."""
        return self.forward(x, head=False)["global_pool"]
