"""Package-level names resolved on first use (PEP 562).

Each subpackage of the port names, in its ``__init__``, the public names of
its JAX twin's ``__all__`` that have a counterpart here, and the module
each lives in; none is imported until a caller asks for it, so importing a
subpackage imports nothing (decode worker processes rely on that).
"""

from __future__ import annotations

import importlib


def lazy_names(package: str, names: dict[str, str]):
    """(__getattr__, __dir__) for ``package``: ``names`` maps each name to
    the module it is taken from, or to the submodule of that name itself."""

    def __getattr__(name: str):
        module = names.get(name)
        if module is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        mod = importlib.import_module(module)
        return mod if module == f"{package}.{name}" else getattr(mod, name)

    def __dir__():
        return sorted(names)

    return __getattr__, __dir__
