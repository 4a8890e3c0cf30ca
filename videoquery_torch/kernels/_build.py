"""Build and load the port's CUDA kernels.

Each kernel is a ``.cu`` file under ``csrc/`` with a plain C interface. At
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build_dir()`` and loaded with ``ctypes``. The library's
name carries a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is reused. Nothing is built when a module is imported.

``build_dir()`` is chosen once a process, by these rules in order:

1. ``$VIDEOQUERY_TORCH_BUILD_DIR``, when it is set;
2. ``<checkout>/build/videoquery_torch_kernels`` (``build/`` is in
   ``.gitignore``), when the package is not installed under a
   ``site-packages`` or ``dist-packages`` directory and the directory
   holding it is writable;
3. otherwise the user's cache: ``$XDG_CACHE_HOME/videoquery_torch/kernels``,
   else ``~/.cache/videoquery_torch/kernels``.

So an installed package never writes beside itself. ``build()`` raises,
naming the directory, when the chosen one cannot be created or written.

    python -m videoquery_torch.kernels._build   # compile every source now

prebuilds every kernel (it needs ``nvcc``, not a GPU), as a deploy image
does at build time, and exits non-zero if any source fails to compile.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import Mapping

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "kernels", "csrc")
BUILD_DIR_ENV = "VIDEOQUERY_TORCH_BUILD_DIR"

# No --use_fast_math: '/' and sqrtf stay correctly rounded. --fmad=false:
# only explicit fmaf() fuses (see query_kernel.cu on reduction order).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_dir: str | None = None
# what the build of each source printed (ptxas register / spill report);
# absent when an existing library was reused
BUILD_LOG: dict[str, str] = {}


def resolve_build_dir(environ: Mapping[str, str] | None = None,
                      package_dir: str = _PKG_DIR) -> str:
    """The kernel build directory for a package at ``package_dir`` under
    the environment ``environ`` (default ``os.environ``), by the module's
    three rules."""
    env = os.environ if environ is None else environ
    override = env.get(BUILD_DIR_ENV)
    if override:
        return os.path.abspath(os.path.expanduser(override))
    parent = os.path.dirname(os.path.abspath(package_dir))
    installed = {"site-packages", "dist-packages"} & set(parent.split(os.sep))
    if not installed and os.access(parent, os.W_OK):
        return os.path.join(parent, "build", "videoquery_torch_kernels")
    cache = env.get("XDG_CACHE_HOME") or os.path.join(
        env.get("HOME") or os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "videoquery_torch", "kernels")


def build_dir() -> str:
    """This process's kernel build directory (resolved at the first call)."""
    global _build_dir
    if _build_dir is None:
        _build_dir = resolve_build_dir()
    return _build_dir


def sources() -> tuple[str, ...]:
    """Every kernel source under ``csrc/``."""
    return tuple(sorted(f for f in os.listdir(_CSRC) if f.endswith(".cu")))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source at first use")


def library_path(source: str) -> str:
    with open(os.path.join(_CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(), f"lib{stem}_{digest.hexdigest()[:16]}.so")


def _make_dir(path: str) -> None:
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as exc:
        raise RuntimeError(f"cannot create the kernel build directory {path}: {exc} "
                           f"(set {BUILD_DIR_ENV} to a writable directory)") from exc
    if not os.access(path, os.W_OK):
        raise RuntimeError(f"the kernel build directory {path} is not writable "
                           f"(set {BUILD_DIR_ENV} to a writable directory)")


def build(sources) -> None:
    """Compile every source of `sources` that has no library yet, one nvcc
    process each, all started together."""
    with _lock:
        todo = [(s, library_path(s)) for s in sources]
        todo = [(s, p) for s, p in todo if not os.path.exists(p)]
        if not todo:
            return
        _make_dir(build_dir())
        nvcc = nvcc_path()
        procs = []
        for source, path in todo:
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, source)]
            procs.append((source, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for source, path, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source}:\n{out}")
                continue
            os.replace(tmp, path)
            BUILD_LOG[source] = out
        if failed:
            raise RuntimeError("\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<source>``, building it first
    if no library of this source and these flags exists yet."""
    build([source])
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(library_path(source))
        return lib


def main() -> int:
    """Prebuild every kernel: the directory, then one line a library."""
    srcs = sources()
    print(f"kernel build directory: {build_dir()}", flush=True)
    failure = None
    try:
        build(srcs)
    except RuntimeError as exc:
        failure = exc
    for source in srcs:
        path = library_path(source)
        how = ("built" if source in BUILD_LOG else "reused") if os.path.exists(path) \
            else "FAILED"
        print(f"{source}: {path} ({how})", flush=True)
    if failure is not None:
        print(failure, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
