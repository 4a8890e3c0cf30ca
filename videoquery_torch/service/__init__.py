"""The broker, its API client and ticket, the loader.

The names below resolve on first use (``videoquery_torch/_lazy.py``);
importing this package imports nothing else. As in the JAX package,
``compute_matches`` is the function, also after its module has been
imported (``sys.modules["videoquery_torch.service.compute_matches"]`` is
the module)."""

import sys
import types

from videoquery_torch._lazy import lazy_names

_NAMES = {
    "ActionClient": "videoquery_torch.service.client",
    "HTTPTransport": "videoquery_torch.service.client",
    "authenticate": "videoquery_torch.service.client",
    "APIRepository": "videoquery_torch.service.repository",
    "Ticket": "videoquery_torch.service.ticket",
    "compute_matches": "videoquery_torch.service.compute_matches",
    "DBLoader": "videoquery_torch.service.loader",
}

__all__ = list(_NAMES)

_getattr, __dir__ = lazy_names(__name__, _NAMES)


def __getattr__(name):
    value = _getattr(name)
    return value.compute_matches if name == "compute_matches" else value


class _Service(types.ModuleType):
    def __setattr__(self, name, value):
        # importing the submodule binds it here: keep the function instead
        if name == "compute_matches" and isinstance(value, types.ModuleType):
            value = value.compute_matches
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Service
