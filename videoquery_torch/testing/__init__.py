"""The port's in-process fake of the Video Query API (a copy of
``videoquery/testing``) and its HTTP bridge.

The names below resolve on first use (``videoquery_torch/_lazy.py``);
importing this package imports nothing else."""

from videoquery_torch._lazy import lazy_names

_NAMES = {
    "FakeAPI": "videoquery_torch.testing.fake_api",
    "FakeClient": "videoquery_torch.testing.fake_api",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_names(__name__, _NAMES)
