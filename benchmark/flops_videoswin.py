"""Video Swin's operations and bytes, matrix product by matrix product,
from shapes.

The backbone of arXiv:2106.13230 / ``swin_transformer.py``'s
``SwinTransformer3D`` at a configuration's widths
(``benchmark/reference/videoswin.py`` holds the same forward), for the V
views of a batch (``batch_clips`` segments x ``num_clips`` clips x
``num_crops`` crops, each ``clip_len`` frames of ``crop_size``²): the
patch projection over the V x D x H x W patches (K = the patch's volume x
3), and in each block of a stage of C channels, h heads and windows of N
tokens, qkv, proj and the MLP's two linears over the stage's V x L tokens
(``2 rows K N`` operations each), and one attention core over the V x
windows x h sequences of N (``4 seqs N^2 (C / h)`` operations: ``q k^T``
and ``@ v``); each PatchMerging's reduction over the V x L / 4 tokens of
the next stage (4C to 2C, no bias).

Compulsory bytes in bf16: a product reads its input and its weight (and
bias) once and writes its output once; an attention core reads q, k and v
once and writes its output once. Neither the relative position bias nor
the shift mask is counted: both follow from the 2,535-row table and the
windows' region ids, so an attention kernel that computes them in place
can read 100% and not more. The glue between the products (LayerNorms,
the pad, roll and window gathers, the merge's concatenation, residual
adds, GELU) is not counted either, nor the final LayerNorm and mean.
``batch_least_time_s`` sums each row's larger bound (operations at 989
TFLOP/s, bytes at 3.35 TB/s): the rows run one after another.
"""

from __future__ import annotations

import math

from benchmark import stats

BYTES = 2        # bf16


def views(config: dict) -> int:
    """The volumes of a batch: segments x clips x crops."""
    return config["batch_clips"] * config["num_clips"] * config["num_crops"]


def stages(config: dict) -> list[dict]:
    """Each stage's tokens a view (d, h, w), channels, heads, depth, window
    (clamped to the tokens, as ``get_window_size`` does) and windows a view
    (the tokens padded to whole windows)."""
    pd, ph, pw = config["patch_size"]
    d = -(-config["clip_len"] // pd)
    h = -(-config["crop_size"] // ph)
    w = -(-config["crop_size"] // pw)
    out = []
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        dims = (d, h, w)
        window = tuple(min(n, ws) for n, ws in zip(dims, config["window_size"]))
        windows = math.prod(-(-n // ws) for n, ws in zip(dims, window))
        out.append({"dims": dims, "c": config["embed_dim"] * 2 ** i, "heads": heads,
                    "depth": depth, "n": math.prod(window), "windows": windows})
        h, w = -(-h // 2), -(-w // 2)
    return out


def gemms(config: dict) -> list[tuple[str, int, int, int, bool]]:
    """Every matrix product of a batch's forward: (name, rows, K, N, bias)."""
    v = views(config)
    s = stages(config)
    patch = math.prod(config["patch_size"]) * 3
    out = [("patch_embed", v * math.prod(s[0]["dims"]), patch, s[0]["c"], True)]
    for i, st in enumerate(s):
        c, rows = st["c"], v * st["windows"] * st["n"]
        tokens = v * math.prod(st["dims"])
        for j in range(st["depth"]):
            pre = f"layers/{i}/blocks/{j}"
            out += [(f"{pre}/attn/qkv", rows, c, 3 * c, True),
                    (f"{pre}/attn/proj", rows, c, c, True),
                    (f"{pre}/mlp/fc1", tokens, c, config["mlp_ratio"] * c, True),
                    (f"{pre}/mlp/fc2", tokens, config["mlp_ratio"] * c, c, True)]
        if i + 1 < len(s):
            out.append((f"layers/{i}/downsample/reduction", v * math.prod(s[i + 1]["dims"]),
                        4 * c, 2 * c, False))
    return out


def attention_cores(config: dict) -> list[tuple[str, int, int, int]]:
    """Every attention core of a batch's forward: (name, sequences, length,
    head dim), one a block."""
    v = views(config)
    out = []
    for i, st in enumerate(stages(config)):
        for j in range(st["depth"]):
            out.append((f"layers/{i}/blocks/{j}/attn", v * st["windows"] * st["heads"],
                        st["n"], st["c"] // st["heads"]))
    return out


def gemm_rows(config: dict) -> list[tuple[str, float, float]]:
    """(name, operations, compulsory bytes) of each matrix product."""
    return [(name, 2.0 * rows * k * n,
             float(BYTES * (rows * k + k * n + (n if bias else 0) + rows * n)))
            for name, rows, k, n, bias in gemms(config)]


def attention_rows(config: dict) -> list[tuple[str, float, float]]:
    """(name, operations, compulsory bytes) of each attention core."""
    return [(name, 4.0 * seqs * length * length * hd, float(BYTES * 4 * seqs * length * hd))
            for name, seqs, length, hd in attention_cores(config)]


def batch_flops(config: dict) -> float:
    """The operations of one batch's forward: every product and attention
    core."""
    return sum(r[1] for r in gemm_rows(config) + attention_rows(config))


def _least(rows) -> float:
    return sum(stats.least_time_s(f, nb) for _name, f, nb in rows)


def batch_least_time_s(config: dict) -> float:
    """The least time the card could take for one batch's products and
    attention cores, one after another."""
    return _least(gemm_rows(config) + attention_rows(config))


def sdpa_least_time_s(config: dict) -> float:
    """The least time of one batch's attention cores alone."""
    return _least(attention_rows(config))
