"""Target estimation, ensemble similarity and scoring, the weight grid and
match selection.

The names below resolve on first use (``videoquery_torch/_lazy.py``);
importing this package imports nothing else."""

from videoquery_torch._lazy import lazy_names

_NAMES = {
    "ensemble_similarities": "videoquery_torch.search.scoring",
    "scores_from_similarities": "videoquery_torch.search.scoring",
    "weighted_scores": "videoquery_torch.search.scoring",
    "GridResult": "videoquery_torch.search.optimizer",
    "optimize_weights": "videoquery_torch.search.optimizer",
    "select_clips_to_review": "videoquery_torch.search.selection",
    "lowest_scoring_user_match": "videoquery_torch.search.selection",
    "scale_feature": "videoquery_torch.search.target",
    "simple_bootstrap": "videoquery_torch.search.target",
    "valid_plus_invalid_bootstrap": "videoquery_torch.search.target",
    "TargetEstimator": "videoquery_torch.search.target",
    "SearchEngine": "videoquery_torch.search.engine",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_names(__name__, _NAMES)
