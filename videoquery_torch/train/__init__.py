"""TSN fine-tuning under DistributedDataParallel (the JAX package's
``train_step``, a pure jitted function of the train state, has no
counterpart: the step is ``TSNTrainer.step``).

The names below resolve on first use (``videoquery_torch/_lazy.py``);
importing this package imports nothing else."""

from videoquery_torch._lazy import lazy_names

_NAMES = {
    "TrainConfig": "videoquery_torch.train.trainer",
    "TSNTrainer": "videoquery_torch.train.trainer",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_names(__name__, _NAMES)
