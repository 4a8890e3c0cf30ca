"""Weight/threshold optimization from user relevance feedback.

The reference runs a 40x30 (weight, threshold) grid search where each of the
1200 loss evaluations re-scores the reviewed clips in a Python loop
(hyperparameter.py:29-76), then refines the grid minimum with a closed-form
2-D parabola fit on the 5-point stencil (hyperparameter.py:78-114). Here the
grid is one vectorized [W, T] numpy computation in float64 on the host: it
only covers the REVIEWED clips (M <= a few hundred), so a device round trip
would cost more than it computes. ``grid_losses`` is the same surface in
f32 on tensors of any device, for similarities that are already there (the
JAX package's jitted twin).

Loss (SURVEY.md Appendix B, reference hyperparameter.py:52-65):

    L(w, th) = [ 0.5*th + sum_m (H(s_m - th) - y_m) * (s_m - th)
                                * (1 + y_m * ballast) ] / M

with H the heaviside step with H(0) = 1 and y_m in {0, 1} the reviewed label
(user_match if given, else is_match — hyperparameter.py:45-50).
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from videoquery_torch.search.scoring import score_weight_grid

log = logging.getLogger(__name__)

_QUAD_FIT_EPS = 1.0e-6  # fit-quality gate (reference hyperparameter.py:103)


@dataclasses.dataclass(frozen=True)
class GridResult:
    weight: float          # optimal second-stream weight (first pinned at 1.0)
    threshold: float       # optimal threshold, already minus COMPUTE_EPS
    losses: np.ndarray     # the full [W, T] loss surface
    grid_index: tuple[int, int]
    fine_tuned: bool


def grid_losses(
    avg_sim_reviewed: torch.Tensor,  # f32[2, M] (M possibly padded)
    labels: torch.Tensor,            # f32[M] in {0, 1}
    weight_grid: torch.Tensor,       # f32[W]
    threshold_grid: torch.Tensor,    # f32[T]
    ballast: "torch.Tensor | float",  # f32 scalar
    valid: torch.Tensor,             # f32[M] 1 for real entries, 0 for padding
) -> torch.Tensor:
    """The full [W, T] loss surface in f32 on the inputs' device; padded
    reviewed entries (valid 0) count for nothing."""
    scores = score_weight_grid(avg_sim_reviewed, weight_grid)       # [W, M]
    d = scores[:, None, :] - threshold_grid[None, :, None]          # [W, T, M]
    heav = torch.where(d >= 0.0, 1.0, 0.0)                          # H(0) = 1
    per_match = (heav - labels) * d * (1.0 + labels * ballast)      # [W, T, M]
    m = valid.sum()
    return (0.5 * threshold_grid[None, :] + (per_match * valid).sum(dim=-1)) / m


def _parabola_vertex(x0: float, x1: float, x2: float,
                     y0: float, y1: float, y2: float) -> float:
    """Vertex of the parabola through (x0,y0), (x1,y1), (x2,y2).

    Written in the same algebraic arrangement as the reference so round-off
    behaves identically (hyperparameter.py:88-92). An exactly flat stencil
    makes the denominator zero (the reference degraded to NaN there); fall
    back to the grid point so the fit-quality check stays meaningful."""
    num = (y2 - y0) * x1 ** 2 + (y1 - y2) * x0 ** 2 - (y1 - y0) * x2 ** 2
    den = (y2 - y0) * x1 + (y1 - y2) * x0 - (y1 - y0) * x2
    if den == 0.0 or not math.isfinite(num / den):
        return x1
    return 0.5 * num / den


def _quad_fine_tune(
    wg: np.ndarray, tg: np.ndarray, losses: np.ndarray, iw: int, it: int
) -> tuple[float, float, bool]:
    """Closed-form separable quadratic fit  a(w-w0)^2 + b(th-th0)^2 + c  on
    the 5-point stencil around the grid minimum, with the reference's
    fit-quality check and grid fallback (hyperparameter.py:78-114)."""
    xw = (float(wg[iw - 1]), float(wg[iw]), float(wg[iw + 1]))
    xt = (float(tg[it - 1]), float(tg[it]), float(tg[it + 1]))
    # Stencil values: (w-,t), (w,t-), (w,t), (w,t+), (w+,t)
    y = (
        float(losses[iw - 1, it]),
        float(losses[iw, it - 1]),
        float(losses[iw, it]),
        float(losses[iw, it + 1]),
        float(losses[iw + 1, it]),
    )
    w0 = _parabola_vertex(xw[0], xw[1], xw[2], y[0], y[2], y[4])
    th0 = _parabola_vertex(xt[0], xt[1], xt[2], y[1], y[2], y[3])
    # Round-off on flat surfaces can push the vertex outside the stencil.
    w0 = min(max(w0, xw[0]), xw[2])
    th0 = min(max(th0, xt[0]), xt[2])
    a = (y[2] - y[0]) / ((xw[1] - w0) ** 2 - (xw[0] - w0) ** 2)
    b = (y[2] - y[1]) / ((xt[1] - th0) ** 2 - (xt[0] - th0) ** 2)
    c = y[2] - a * (xw[1] - w0) ** 2 - b * (xt[1] - th0) ** 2

    def model(xw_, xt_):
        return a * (xw_ - w0) ** 2 + b * (xt_ - th0) ** 2 + c

    resid = (
        abs(y[0] - model(xw[0], xt[1]))
        + abs(y[1] - model(xw[1], xt[0]))
        + abs(y[2] - model(xw[1], xt[1]))
        + abs(y[3] - model(xw[1], xt[2]))
        + abs(y[4] - model(xw[2], xt[1]))
    )
    if resid > _QUAD_FIT_EPS:
        log.warning(
            "quadratic fine-tune residual %.3e exceeds %.0e; keeping grid optimum",
            resid, _QUAD_FIT_EPS,
        )
        return float(wg[iw]), float(tg[it]), False
    return w0, th0, True


def _grid_losses_host_f64(
    avg_sim: np.ndarray, labels: np.ndarray,
    weight_grid: np.ndarray, threshold_grid: np.ndarray, ballast: float,
) -> np.ndarray:
    """Float64 host grid for the exact (reference-parity) mode; numpy
    broadcasting (the grid is tiny: 40x30xM)."""
    s = np.asarray(avg_sim, np.float64)
    w = np.asarray(weight_grid, np.float64)[:, None]
    num = (1.0 - s[0]) ** 2 + (w * (1.0 - s[1])) ** 2
    scores = 1.0 - np.sqrt(num / (1.0 + w * w))               # [W, M]
    d = scores[:, None, :] - np.asarray(threshold_grid)[None, :, None]
    heav = np.where(d >= 0.0, 1.0, 0.0)
    per = (heav - labels) * d * (1.0 + labels * ballast)
    return (0.5 * np.asarray(threshold_grid)[None, :] + per.sum(axis=-1)) / labels.size


def optimize_weights(
    avg_sim_reviewed: np.ndarray,  # f32[2, M] similarities of reviewed clips
    labels: np.ndarray,            # [M] 0/1 labels
    weight_grid: np.ndarray,
    threshold_grid: np.ndarray,
    ballast: float,
    eps: float,
) -> GridResult:
    """Grid search + parabolic refinement. Returns the new (weight, threshold)
    with threshold already buffered by -eps (reference hyperparameter.py:75).
    """
    if avg_sim_reviewed.shape[0] != 2:
        raise ValueError("the weight sweep pins stream 0 and sweeps stream 1; "
                         f"got {avg_sim_reviewed.shape[0]} streams")
    if labels.size == 0:
        raise ValueError("cannot optimize with zero reviewed matches")
    losses = _grid_losses_host_f64(
        avg_sim_reviewed, np.asarray(labels, np.float64),
        weight_grid, threshold_grid, ballast,
    )
    iw, it = np.unravel_index(np.argmin(losses), losses.shape)
    on_border = (
        iw == 0 or it == 0
        or iw == len(weight_grid) - 1 or it == len(threshold_grid) - 1
    )
    if on_border:
        w_opt, th_opt, tuned = float(weight_grid[iw]), float(threshold_grid[it]), False
    else:
        w_opt, th_opt, tuned = _quad_fine_tune(
            np.asarray(weight_grid, np.float64),
            np.asarray(threshold_grid, np.float64),
            losses, int(iw), int(it),
        )
    return GridResult(
        weight=w_opt,
        threshold=th_opt - eps,
        losses=losses,
        grid_index=(int(iw), int(it)),
        fine_tuned=tuned,
    )
