"""TimeSformer's operations and bytes, matrix product by matrix product,
from shapes.

The divided space-time encoder of arXiv:2102.05095 / TimeSformer's
``vit.py`` at a configuration's widths (``benchmark/reference/timesformer.py``
holds the same forward): for B segments of T frames of N patches, D wide,
H heads of D / H, an MLP of M, the patch projection and, in each block, the
time attention's qkv, proj and ``temporal_fc`` over the B N T patch tokens,
the space attention's qkv and proj over B T (1 + N) tokens, the MLP's two
linears over B (1 + N T) tokens (``2 rows K N`` operations each), and the
two attention cores (``4 seqs L^2 (D / H)`` operations: ``q k^T`` and ``@
v``; time: B N H sequences of L = T, space: B T H of L = 1 + N).

Compulsory bytes in bf16: a product reads its input and its weight (and
bias) once and writes its output once; an attention core reads q, k and v
once and writes its output once. The glue between them (LayerNorms, the
layout moves, the CLS token's concatenation and mean, residual adds,
GELU) is not counted, so no fusion of it can read above 100%, and neither
are the final LayerNorm and the head (the extraction step stops at the CLS
row). ``batch_least_time_s`` sums each row's larger bound (operations at
989 TFLOP/s, bytes at 3.35 TB/s): the rows run one after another.
"""

from __future__ import annotations

from benchmark import stats

BYTES = 2        # bf16


def shapes(config: dict) -> dict:
    p = config["patch_size"]
    return {"b": config["batch_clips"], "t": config["num_frames"],
            "n": (config["crop_size"] // p) ** 2, "d": config["embed_dim"],
            "h": config["num_heads"], "m": config["mlp_dim"], "depth": config["depth"],
            "k_patch": p * p * 3}


def gemms(config: dict) -> list[tuple[str, int, int, int]]:
    """Every matrix product of a batch's forward: (name, rows, K, N)."""
    s = shapes(config)
    b, t, n, d, m = s["b"], s["t"], s["n"], s["d"], s["m"]
    patches, frames_rows, tokens = b * n * t, b * t * (1 + n), b * (1 + n * t)
    out = [("patch_embed", patches, s["k_patch"], d)]
    for i in range(s["depth"]):
        out += [(f"blocks/{i}/temporal_attn/qkv", patches, d, 3 * d),
                (f"blocks/{i}/temporal_attn/proj", patches, d, d),
                (f"blocks/{i}/temporal_fc", patches, d, d),
                (f"blocks/{i}/attn/qkv", frames_rows, d, 3 * d),
                (f"blocks/{i}/attn/proj", frames_rows, d, d),
                (f"blocks/{i}/mlp/fc1", tokens, d, m),
                (f"blocks/{i}/mlp/fc2", tokens, m, d)]
    return out


def attention_cores(config: dict) -> list[tuple[str, int, int, int]]:
    """Every attention core of a batch's forward: (name, sequences, length,
    head dim), 2 a block."""
    s = shapes(config)
    b, t, n, h, hd = s["b"], s["t"], s["n"], s["h"], s["d"] // s["h"]
    out = []
    for i in range(s["depth"]):
        out += [(f"blocks/{i}/temporal_attn", b * n * h, t, hd),
                (f"blocks/{i}/attn", b * t * h, 1 + n, hd)]
    return out


def gemm_rows(config: dict) -> list[tuple[str, float, float]]:
    """(name, operations, compulsory bytes) of each matrix product."""
    return [(name, 2.0 * rows * k * n, float(BYTES * (rows * k + k * n + n + rows * n)))
            for name, rows, k, n in gemms(config)]


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
