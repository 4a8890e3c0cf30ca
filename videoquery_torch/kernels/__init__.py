"""The CUDA kernels' wrappers and the flow around them (``videoquery.kernels``'s
names with a counterpart; ``tvl1_flow`` here is the submodule of the flow
on K2 and K3, so the gather solver's function of that name stays
``kernels.tvl1.tvl1_flow``).

The names below resolve on first use (``videoquery_torch/_lazy.py``);
importing this package imports nothing else."""

from videoquery_torch._lazy import lazy_names

_NAMES = {
    "TVL1Params": "videoquery_torch.kernels.tvl1",
    "tvl1_warped_flow": "videoquery_torch.kernels.tvl1",
    "bilinear_warp": "videoquery_torch.kernels.warp",
    "warp_affine": "videoquery_torch.kernels.warp",
    "estimate_affine": "videoquery_torch.kernels.motion",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_names(__name__, _NAMES)
