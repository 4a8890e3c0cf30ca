"""Extraction pipeline: video -> flow and rgb ticks -> TSN -> feature CSVs.

The names below resolve on first use (``videoquery_torch/_lazy.py``);
importing this package imports nothing else."""

from videoquery_torch._lazy import lazy_names

_NAMES = {
    "frame_ticks": "videoquery_torch.pipeline.sampling",
    "clip_ranges": "videoquery_torch.pipeline.sampling",
    "preprocess_rgb": "videoquery_torch.pipeline.preprocess",
    "preprocess_flow": "videoquery_torch.pipeline.preprocess",
    "BGR_MEAN": "videoquery_torch.pipeline.preprocess",
    "FLOW_MEAN": "videoquery_torch.pipeline.preprocess",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_names(__name__, _NAMES)
