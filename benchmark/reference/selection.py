"""Judging a round's selection by the reference broker's rules.

The rules (ticket.py:311-356 of the original broker, SURVEY.md): clips
scoring at or above the threshold are matches, those in
[threshold - near_miss (1 - threshold), threshold) near misses; up to half
the review budget is drawn from the matches, the rest from the near
misses, one near-miss slot held for the best near miss; the reference clip
and every clip the user confirmed are always included.

The draw is random, so a selection is judged by what it says and not
compared id for id: each rule is checked against the reference's scores.
A clip within ``tol`` of a class boundary may fall in either class.
"""

from __future__ import annotations

import math
import random
from typing import Mapping


def judge(selected, ref_score: dict, kept, threshold: float, near_miss: float,
          max_matches: float, tol: float) -> list[str]:
    """The rules the selection breaks (an empty list when it keeps them).
    ``ref_score``: {clip id: reference score} of every scored clip at or
    above the band's lower bound less 2 tol, and of the kept clips."""
    lower = threshold - near_miss * (1.0 - threshold)
    selected = set(int(c) for c in selected)
    kept = set(int(c) for c in kept if int(c) in ref_score)
    faults = []
    if not kept <= selected:
        faults.append(f"kept clips missing: {sorted(kept - selected)[:5]}")
    surely_match = {c for c, s in ref_score.items() if s >= threshold + tol}
    maybe_match = {c for c, s in ref_score.items() if s >= threshold - tol}
    surely_near = {c for c, s in ref_score.items() if lower + tol <= s < threshold - tol}
    maybe_near = {c for c, s in ref_score.items() if lower - tol <= s < threshold + tol}
    outside = selected - kept - maybe_match - maybe_near
    if outside:
        faults.append(f"selected outside the band: {sorted(outside)[:5]}")
    drawn = selected - kept
    # matches: min(budget / 2, candidates), however boundary clips fall
    n_match_hi = int(min(max_matches / 2, len(maybe_match)))
    n_match_lo = int(min(max_matches / 2, len(surely_match)))
    if len(drawn & surely_match) > n_match_hi:
        faults.append(f"{len(drawn & surely_match)} matches drawn, at most {n_match_hi}")
    # near misses fill the rest of the budget
    n_near_lo = int(min(max_matches - n_match_hi, len(surely_near)))
    n_total_lo = n_match_lo + n_near_lo
    if len(selected) < n_total_lo - len(kept) or len(selected) < len(kept):
        faults.append(f"{len(selected)} selected, at least {n_total_lo} - {len(kept)} kept")
    if not math.isinf(max_matches) and len(selected) > max_matches + len(kept):
        faults.append(f"{len(selected)} selected over a budget of {max_matches}")
    # the best near miss: the best clip surely below the threshold, or one
    # within tol of it, or a boundary clip that ranked as a near miss
    below = [s for c, s in ref_score.items() if c in maybe_near and s < threshold - tol]
    if below and n_near_lo > 0:
        best = max(below)
        tied = {c for c in maybe_near if ref_score[c] >= best - 2 * tol}
        if not tied & selected:
            faults.append("the best near miss is not selected")
    return faults


# A frozen copy of ``videoquery_torch/search/selection.py::
# select_clips_to_review`` (the reference broker's ticket.py:311-356), for
# the control, which draws its own selection from its own scores.
def select(
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
