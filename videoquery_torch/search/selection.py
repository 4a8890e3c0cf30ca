"""Match / near-miss selection for human review.

Host-side and deliberately tiny: selection operates on the (already
device-computed) score table and is O(N) Python, exactly where the
reference's semantics live (ticket.py:311-356). Randomness uses a
`random.Random` seeded from RANDOM_SEED for reproducibility
(reference broker.py:83-84, README.md:35-38).

Determinism note (SURVEY.md §7 "hard parts"): the reference samples from
dicts whose iteration order is the order clips happened to arrive from the
API. This framework specifies a canonical order — ascending clip id — so
runs are reproducible across machines. With the same seed and the same
canonical order the sampling procedure is CPython `random.sample`, identical
to the reference's; bit-identical selections vs the reference are only
guaranteed when the reference's dicts were also in ascending-clip-id order.
"""

from __future__ import annotations

import math
import random
from typing import Mapping

from videoquery_torch.core.profiling import spanned


def lowest_scoring_user_match(
    scores: Mapping[int, float], user_matches: Mapping[str, bool | None]
) -> tuple[float, int | None]:
    """Lowest score among user-confirmed matches (reference ticket.py:301-309)."""
    min_score, min_clip = 1.0, None
    for clip, score in scores.items():
        if user_matches.get(str(clip)) is True:
            if score <= min_score:
                min_score, min_clip = min(min_score, score), clip
    return min_score, min_clip


def select_clips_to_review(
    scores: Mapping[int, float],
    user_matches: Mapping[str, bool | None],
    ref_clip_id: int | None,
    threshold: float = 0.8,
    max_number_matches: float = 20,
    near_miss: float = 0.5,
    rng: random.Random | None = None,
) -> dict[int, float]:
    """Choose matches plus near-misses for user review (ticket.py:311-356).

    - candidates >= threshold are matches; scores in
      [threshold - near_miss*(1-threshold), threshold) are near-misses.
    - up to max/2 matches sampled at random, the rest of the budget goes to
      near-misses; one near-miss slot is reserved for the best near-miss.
    - the reference clip and every previously user-validated match are always
      re-included.

    `scores` must be in canonical ascending-clip-id order (dicts preserve
    insertion order); `max_number_matches` may be math.inf for finalize jobs
    (compute_matches.py:79).
    """
    if rng is None:
        rng = random  # module-level, seeded by the broker like the reference

    lower_limit = threshold - near_miss * (1.0 - threshold)
    match_candidates = {k: v for k, v in scores.items() if v >= threshold}
    near_candidates = {
        k: v for k, v in scores.items() if lower_limit <= v < threshold
    }

    n_matches = int(min(max_number_matches / 2, len(match_candidates)))
    n_near = int(min(max_number_matches - n_matches, len(near_candidates)))
    picked = dict(rng.sample(list(match_candidates.items()), n_matches))

    # Reserve one slot for the highest-scoring near-miss (ticket.py:334-340).
    best_near: dict[int, float] = {}
    if n_near > 0:
        n_near -= 1
        best_key = max(near_candidates, key=lambda k: near_candidates[k])
        best_near = {best_key: scores[best_key]}
        near_candidates.pop(best_key)
    picked.update(dict(rng.sample(list(near_candidates.items()), n_near)))
    picked.update(best_near)

    # Always keep the reference clip (if it is in the search set) and every
    # clip the user already validated as a match (ticket.py:346-356).
    keep: dict[int, float] = {}
    if ref_clip_id is not None and ref_clip_id in scores:
        keep[ref_clip_id] = scores[ref_clip_id]
    for clip_str, value in user_matches.items():
        if value is True:
            clip = int(clip_str)
            if clip in scores:
                keep[clip] = scores[clip]
    picked.update(keep)
    return picked


# the copy above keeps the JAX package's code word for word; its calls are
# the selection layer's span
select_clips_to_review = spanned("selection", select_clips_to_review)


def finalize_near_miss(threshold: float, low_user_score: float, eps: float) -> float:
    """Near-miss band for finalize jobs: stretch down to the lowest-scoring
    user match, guarding the threshold~1 divide-by-zero with COMPUTE_EPS
    (reference compute_matches.py:78-85)."""
    return max(threshold - low_user_score, 0.0) / max(1.0 - threshold, eps)


INFINITE_MATCHES = math.inf
