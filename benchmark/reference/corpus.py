"""The corpus cells' reference: ensemble similarities, scores and top-k.

Semantics of the reference system (ticket.py:124,154-180 of the original
broker, SURVEY.md): a clip's similarity to a target in a stream is the mean
over the splits that both hold of the dot products; a clip missing a
stream is not scored; its score under weights w is

    1 - sqrt( sum_s (w_s (1 - sim_s))^2 / sum_s w_s^2 ).

Targets arrive as float64 lists and are rounded to float32 once, as the
search service does; a top-k query rounds them to the index's dtype first,
as the search kernel casts them. Everything after that is float64 here:
the products of bf16 features and f32 targets are exact, so the reference
is the exact result of the stated arithmetic up to f64 rounding.

``cast`` puts a lower-precision copy of the index in the program's place
(the control).
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 17


def pack_targets(targets: list[dict], streams, splits, dim: int,
                 round_to: torch.dtype | None = None):
    """Q target dicts -> (f64[Q, S, K, D] holding f32 values, bool[Q, S, K])
    on the host; ``round_to`` rounds the f32 values once more (the top-k
    query's cast to the index dtype)."""
    t = np.zeros((len(targets), len(streams), len(splits), dim), np.float32)
    m = np.zeros((len(targets), len(streams), len(splits)), bool)
    for qi, target in enumerate(targets):
        for si, stream in enumerate(streams):
            for ki, split in enumerate(splits):
                vec = target.get(stream, {}).get(split)
                if vec is not None:
                    t[qi, si, ki] = np.asarray(vec, np.float64).astype(np.float32)
                    m[qi, si, ki] = True
    tt = torch.from_numpy(t)
    if round_to is not None:
        tt = tt.to(round_to).float()
    return tt.double(), torch.from_numpy(m)


def similarities(feats: torch.Tensor, mask: torch.Tensor, targets: torch.Tensor,
                 tmask: torch.Tensor, cast=None, block_rows: int = BLOCK_ROWS):
    """avg f64[Q, S, Npad] and counts i32[Q, S, Npad] on the index's device:
    each member's dot products in float64, a block of rows at a time, then
    the mean over the splits present in both clip and target (0 where
    none)."""
    s, k, n, d = feats.shape
    dev = feats.device
    t = targets.to(dev)                                  # [Q, S, K, D]
    tm = tmask.to(dev)
    m = mask[None] & tm[..., None]                       # [Q, S, K, N]
    counts = m.sum(dim=2, dtype=torch.int32)             # [Q, S, N]
    total = torch.zeros((t.shape[0], s, n), dtype=torch.float64, device=dev)
    for si in range(s):
        for ki in range(k):
            for a in range(0, n, block_rows):
                b = min(n, a + block_rows)
                f = feats[si, ki, a:b]
                f = (cast(f) if cast is not None else f).double()
                dots = t[:, si, ki] @ f.T                 # [Q, rows]
                total[:, si, a:b] += torch.where(m[:, si, ki, a:b], dots, 0.0)
                del f, dots
    return total / counts.clamp(min=1).double(), counts


def scores(avg: torch.Tensor, counts: torch.Tensor, weights) -> torch.Tensor:
    """f64[..., N]: the weighted score, -inf where a stream has no member.
    ``weights`` [..., S] (a tensor on avg's device, or a sequence)."""
    w = torch.as_tensor(weights, dtype=torch.float64, device=avg.device)
    dev = w[..., :, None] * (1.0 - avg)
    sc = 1.0 - torch.sqrt((dev * dev).sum(dim=-2) / (w * w).sum(dim=-1)[..., None])
    valid = (counts > 0).all(dim=-2)
    return torch.where(valid, sc, torch.tensor(-torch.inf, dtype=sc.dtype, device=sc.device))


def topk(sc: torch.Tensor, k: int):
    """(values f64[Q, k], positions i64[Q, k]) of the best scores."""
    return torch.topk(sc, k, dim=-1)
