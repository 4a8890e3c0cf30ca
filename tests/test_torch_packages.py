"""The port's package-level names against the JAX package's.

Every name in a JAX subpackage's ``__all__`` resolves on the port's twin
subpackage (PEP 562, ``videoquery_torch/_lazy.py``) to a counterpart of
the same kind, or is listed in MISSING with the reason it has none.
Importing a port subpackage imports none of its modules, and
``videoquery_torch.service.compute_matches`` is the function, as in the
JAX package.
"""

import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = ("core", "index", "kernels", "nn", "pipeline", "search", "service",
            "testing", "train")

MISSING = {
    "core.data_sharding": "builds a JAX NamedSharding; a rank of the port holds its "
                          "shard itself (FeatureIndex.shard, the extractor's rows)",
    "core.replicated_sharding": "builds a JAX NamedSharding; a replicated tensor is "
                                "an ordinary tensor on each rank",
    "kernels.tvl1_flow": "the port's submodule kernels/tvl1_flow.py (the flow on K2 and "
                         "K3) has that name; the gather solver's function is "
                         "kernels.tvl1.tvl1_flow",
    "nn.stack_params": "stacks JAX pytrees for vmap; a port stream holds one module a "
                       "split",
    "train.train_step": "a pure jitted function of the JAX train state; the port's "
                        "step is TSNTrainer.step under DDP",
}


def kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "function"
    return type(obj).__name__


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_names_match_the_jax_twin(pkg):
    jax_pkg = importlib.import_module(f"videoquery.{pkg}")
    port_pkg = importlib.import_module(f"videoquery_torch.{pkg}")
    for name in jax_pkg.__all__:
        key = f"{pkg}.{name}"
        if key in MISSING:
            assert name not in port_pkg.__all__, key
            continue
        assert name in port_pkg.__all__, f"{key} is neither ported nor listed as missing"
        got, want = getattr(port_pkg, name), getattr(jax_pkg, name)
        if kind(want) not in ("module", "class", "function"):      # a constant
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=key)
            continue
        assert kind(got) == kind(want), (key, kind(got), kind(want))
        if kind(got) != "module":
            assert got.__module__.startswith(f"videoquery_torch.{pkg}."), (key, got.__module__)
        else:
            assert got.__name__ == f"videoquery_torch.{pkg}.{name}"
    # nothing listed that the twin does not have
    assert set(port_pkg.__all__) <= set(jax_pkg.__all__)
    assert {k for k in MISSING if k.startswith(pkg + ".")} <= \
        {f"{pkg}.{n}" for n in jax_pkg.__all__}


def test_packages_import_nothing_until_asked():
    code = ("import sys, importlib\n"
            f"pkgs = {PACKAGES!r}\n"
            "for p in pkgs:\n"
            "    importlib.import_module('videoquery_torch.' + p)\n"
            "loaded = [m for m in sys.modules if m.startswith('videoquery_torch.')\n"
            "          and m.count('.') > 1]\n"
            "assert not loaded, loaded\n"
            "assert 'torch' not in sys.modules\n"
            "from videoquery_torch.search import SearchEngine\n"
            "assert 'videoquery_torch.search.engine' in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


def test_service_compute_matches_is_the_function():
    """As in the JAX package, also after the module has been imported."""
    import videoquery.service as jax_service
    import videoquery_torch.service as service

    cm = importlib.import_module("videoquery_torch.service.compute_matches")
    assert inspect.ismodule(cm)
    assert service.compute_matches is cm.compute_matches
    assert inspect.isfunction(jax_service.compute_matches)
    from videoquery_torch.service import compute_matches
    assert compute_matches is cm.compute_matches
