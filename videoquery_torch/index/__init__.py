"""The embedding index and the reference feature-CSV format.

The names below resolve on first use (``videoquery_torch/_lazy.py``);
importing this package imports nothing else."""

from videoquery_torch._lazy import lazy_names

_NAMES = {
    "FeatureIndex": "videoquery_torch.index.store",
    "FeatureRecord": "videoquery_torch.index.records",
    "FeatureCSV": "videoquery_torch.index.csvio",
    "read_features_csv": "videoquery_torch.index.csvio",
    "write_features_csv": "videoquery_torch.index.csvio",
    "read_feature_tree": "videoquery_torch.index.csvio",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_names(__name__, _NAMES)
