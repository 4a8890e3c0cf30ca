"""Ensemble similarity and scoring on tensors.

Array layout (the framework-wide convention):

    targets    : f32[Q, S, K, D]   one target per (query, stream, split)
    target_mask: bool[Q, S, K]     split present in the target?
    cands      : [S, K, N, D]      candidate features (the search-set index),
                                   float32 or bfloat16
    cand_mask  : bool[S, K, N]     feature present for (stream, split, clip)?

S = streams (2: rgb, warped_optical_flow), K = splits (3), N = clips,
D = 1024. A clip that misses a split is averaged over the splits it has
(reference ticket.py:154-160); a clip missing a stream is excluded from
scoring.
"""

from __future__ import annotations

import torch

from videoquery_torch.kernels.query import query_k1


def ensemble_similarities(
    targets: torch.Tensor,      # f32[S, K, D]
    target_mask: torch.Tensor,  # bool[S, K]
    cands: torch.Tensor,        # [S, K, N, D]
    cand_mask: torch.Tensor,    # bool[S, K, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """One target's per-(stream, clip) ensemble-averaged similarity, plain
    torch: (avg_sim f32[S, N], counts int32[S, N]), the batched form of the
    reference's ``{clip: {stream: [avg_sim, n_ensemble]}}``
    (ticket.py:124,154-160). f32 products and sums, as the JAX function's
    HIGHEST-precision einsum."""
    sims = torch.einsum("sknd,skd->skn", cands.float(), targets.float())
    mask = cand_mask & target_mask[:, :, None]                  # [S, K, N]
    counts = mask.sum(dim=1, dtype=torch.int32)                 # [S, N]
    total = torch.where(mask, sims, 0.0).sum(dim=1)             # [S, N]
    return total / counts.clamp(min=1).float(), counts


def ensemble_similarities_batched(
    targets: torch.Tensor,      # f32[Q, S, K, D]
    target_mask: torch.Tensor,  # bool[Q, S, K]
    cands: torch.Tensor,        # [S, K, N, D]  the SHARED search-set index
    cand_mask: torch.Tensor,    # bool[S, K, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Q concurrent queries over one search set: (avg_sim f32[Q, S, N],
    counts int32[Q, S, N]) from K1's avg+counts epilogue, which reads the
    index once for all Q. The targets stay f32 against either index dtype.

    Bit-compatibility contract: a query's output is bit-identical whatever
    other queries share the batch (K1 sums each dot product over D in an
    order fixed by D alone: fmaf over d for an f32 index, 16-deep tensor-core
    k-steps on the three bf16 terms of each f32 target for a bf16 one), so
    batched and one-job-per-poll serving agree.
    """
    return query_k1(cands, cand_mask, targets, target_mask,
                    target_dtype=torch.float32)


def scores_from_similarities(avg_sim: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Weighted ensemble score (reference ticket.py:165-180):

        score = 1 - sqrt( sum_s (w_s * (1 - sim_s))^2 / sum_s w_s^2 )

    avg_sim [..., S, N], weights [..., S] -> [..., N]. The sums over s run
    in order, elementwise, so a row's bits do not depend on the batch."""
    num = torch.zeros_like(avg_sim[..., 0, :])
    den = torch.zeros_like(weights[..., 0])
    for si in range(avg_sim.shape[-2]):
        w = weights[..., si]
        dev = w[..., None] * (1.0 - avg_sim[..., si, :])
        num = num + dev * dev
        den = den + w * w
    return 1.0 - torch.sqrt(num / den[..., None])


def weighted_scores(
    avg_sim: torch.Tensor,   # f32[S, N]
    counts: torch.Tensor,    # int32[S, N]
    weights: torch.Tensor,   # f32[S]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scores of every clip and the validity mask: a clip is valid iff it
    has at least one ensemble member for every stream; invalid clips score
    -inf, so they never select as matches."""
    valid = (counts > 0).all(dim=0)                              # bool[N]
    scores = scores_from_similarities(avg_sim, weights)
    return torch.where(valid, scores, -torch.inf), valid


def score_weight_grid(
    avg_sim_reviewed: torch.Tensor,  # f32[2, M] similarities of reviewed clips
    weight_grid: torch.Tensor,       # f32[W] grid over the second stream's weight
    pin_first_weight: bool = True,
) -> torch.Tensor:
    """Scores of the reviewed clips for every grid weight, f32[W, M]: the
    first stream's weight pinned at 1.0 and the second's swept, as the
    reference's optimizer does (hyperparameter.py:58,76). Only 2-stream
    sweeps, like the reference; only pin_first_weight=True is implemented
    (the JAX signature keeps the flag)."""
    if not pin_first_weight:
        raise NotImplementedError("only the pinned first weight is implemented")
    s = avg_sim_reviewed
    w = weight_grid[:, None]
    num = (1.0 - s[0]) ** 2 + (w * (1.0 - s[1])) ** 2
    den = 1.0 + w * w
    return 1.0 - torch.sqrt(num / den)
