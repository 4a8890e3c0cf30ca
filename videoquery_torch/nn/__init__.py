"""BN-Inception and the two-stream TSN ensemble in PyTorch (``stack_params``
stacks JAX pytrees for vmap and has no counterpart: a stream holds one
module a split).

The names below resolve on first use (``videoquery_torch/_lazy.py``);
importing this package imports nothing else."""

from videoquery_torch._lazy import lazy_names

_NAMES = {
    "bn_inception": "videoquery_torch.nn.bn_inception",
    "StreamEnsemble": "videoquery_torch.nn.tsn",
    "TwoStreamTSN": "videoquery_torch.nn.tsn",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_names(__name__, _NAMES)
