"""Configuration and meshes of the port (``videoquery.core``'s names with a
counterpart; ``data_sharding`` and ``replicated_sharding`` build JAX
``NamedSharding`` objects and have none: a rank holds its shard itself).

The names below resolve on first use (``videoquery_torch/_lazy.py``);
importing this package imports nothing else."""

from videoquery_torch._lazy import lazy_names

_NAMES = {
    "BrokerConfig": "videoquery_torch.core.config",
    "ExtractionConfig": "videoquery_torch.core.config",
    "HyperParams": "videoquery_torch.core.config",
    "SearchConfig": "videoquery_torch.core.config",
    "compute_eps": "videoquery_torch.core.config",
    "make_mesh": "videoquery_torch.core.meshes",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_names(__name__, _NAMES)
