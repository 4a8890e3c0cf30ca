"""The port installed from its wheel, as the packaging test and the smoke run
hold it.

``install(repo, tmp)`` builds the project's wheel from a copy of
``pyproject.toml``, ``videoquery/`` and ``videoquery_torch/`` under ``tmp``
(``pip wheel .`` writes ``build/`` and ``*.egg-info`` into the tree it
builds, so never in the checkout), installs it with ``pip install --no-deps
--no-index`` into a fresh venv, lets the venv reach this interpreter's
site-packages (torch, numpy, cv2) through a ``.pth`` placed after its own,
so the wheel is the only ``videoquery_torch`` on the path, and makes the
venv's site-packages read-only. Root writes through a read-only mode, so a
caller holds ``file_tree(site)`` unchanged to show that nothing was written
there. ``BLOCKER`` is the code each child runs first: a ``sys.meta_path``
finder that refuses jax and the JAX package (``videoquery``).
"""

from __future__ import annotations

import os
import shutil
import stat
import subprocess
import sys
import sysconfig

BLOCKER = """
import sys

class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "videoquery"):
            raise ImportError(f"the installed port imported {name}")
        return None

sys.meta_path.insert(0, _BlockJax())
"""


def file_tree(root: str) -> set[str]:
    """Every file and directory under root, relative to it."""
    return {os.path.relpath(os.path.join(d, f), root)
            for d, dirs, files in os.walk(root) for f in files + dirs}


def _run(cmd, cwd=None) -> str:
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {r.returncode}:\n{r.stdout}\n{r.stderr}")
    return r.stdout


def install(repo: str, tmp: str) -> tuple[str, str, str]:
    """(the venv's python, its read-only site-packages, the wheel)."""
    src = os.path.join(tmp, "src")
    os.makedirs(src)
    shutil.copy(os.path.join(repo, "pyproject.toml"), src)
    for pkg in ("videoquery", "videoquery_torch"):
        shutil.copytree(os.path.join(repo, pkg), os.path.join(src, pkg),
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so"))
    dist = os.path.join(tmp, "dist")
    _run([sys.executable, "-m", "pip", "wheel", ".", "--no-deps", "--no-build-isolation",
          "-w", dist], cwd=src)
    wheel, = (os.path.join(dist, f) for f in os.listdir(dist) if f.endswith(".whl"))
    venv = os.path.join(tmp, "venv")
    _run([sys.executable, "-m", "venv", venv])
    py = os.path.join(venv, "bin", "python")
    _run([py, "-m", "pip", "install", "--no-deps", "--no-index", wheel])
    site = _run([py, "-c", "import site; print(site.getsitepackages()[0])"]).strip()
    with open(os.path.join(site, "_parent_deps.pth"), "w") as f:
        f.write(sysconfig.get_paths()["purelib"] + "\n")
    for d, dirs, files in os.walk(site):
        for name in dirs + files:
            path = os.path.join(d, name)
            os.chmod(path, os.stat(path).st_mode & ~(stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH))
    os.chmod(site, 0o555)
    return py, site, wheel


def make_writable(site: str) -> None:
    """Give the venv's directories back their write bit, so its temporary
    directory can be removed."""
    for d, _dirs, _files in os.walk(site):
        os.chmod(d, 0o755)
