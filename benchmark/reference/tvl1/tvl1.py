# A frozen copy of videoquery_torch/kernels/tvl1.py (TVL1Params and the pyramid's shapes only), for the
# benchmark's reference; it imports nothing of the program.
"""TV-L1's parameters (``TVL1Params``; the comments in the program's copy
say why each default was chosen) and the pyramid's geometry."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TVL1Params:
    tau: float = 0.25           # dual time step
    lambda_: float = 38.25      # data weight for [0, 1] intensities (0.15 x 255)
    theta: float = 0.3          # tightness
    n_scales: int = 5
    n_warps: int = 5
    n_iters: int = 30           # primal-dual iterations per warp
    scale_step: float = 0.5
    grad_eps: float = 1e-6
    fine_warps: int | None = None   # warps at the finest 2 levels (None = n_warps)
    fine_iters: int | None = None   # iterations at the finest 2 levels
    warm_iters: int | None = None   # iterations of a warm pair's refinement
    warm_warps: int = 1             # warps of a warm pair's refinement
    # factorized window warp: a vertical then a horizontal 2-tap pass
    separable_warp: bool = True
    coarse_hw: tuple[int, int] = (48, 64)   # camera-estimation grid
    rescue_frac: float = 0.0        # fraction of pairs a rescue may re-solve
    rescue_trigger: float = 0.9     # pooled peak |flow| >= trigger * max_disp
    camera_model: str = "affine"    # "affine" (6 params) or "homography" (8)
    grad_source: str = "image"      # "image" | "warped" (separable only)

    def warps_at_level(self, level: int) -> int:
        if self.fine_warps is not None and level < 2:
            return min(self.n_warps, self.fine_warps)
        return self.n_warps

    def iters_at_level(self, level: int) -> int:
        if self.fine_iters is not None and level < 2:
            return min(self.n_iters, self.fine_iters)
        return self.n_iters

    def at_level(self, level: int) -> "TVL1Params":
        return dataclasses.replace(self, n_warps=self.warps_at_level(level),
                                   n_iters=self.iters_at_level(level))


def _pyramid_shapes(h: int, w: int, p: TVL1Params) -> list[tuple[int, int]]:
    shapes = [(h, w)]
    for _ in range(p.n_scales - 1):
        h = max(int(round(h * p.scale_step)), 16)
        w = max(int(round(w * p.scale_step)), 16)
        if (h, w) == shapes[-1]:
            break
        shapes.append((h, w))
    return shapes
