"""Build and load the port's CUDA kernels.

Each kernel is a ``.cu`` file under ``csrc/`` with a plain C interface. At
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/videoquery_torch_kernels/`` at the repository root
(``build/`` is in ``.gitignore``) and loaded with ``ctypes``. The library's
name carries a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is reused. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "kernels", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "videoquery_torch_kernels")

# No --use_fast_math: '/' and sqrtf stay correctly rounded. --fmad=false:
# only explicit fmaf() fuses (see query_kernel.cu on reduction order).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# what the build of each source printed (ptxas register / spill report);
# absent when an existing library was reused
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source at first use")


def _library_path(source: str) -> str:
    with open(os.path.join(_CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(sources) -> None:
    """Compile every source of `sources` that has no library yet, one nvcc
    process each, all started together."""
    with _lock:
        todo = [(s, _library_path(s)) for s in sources]
        todo = [(s, p) for s, p in todo if not os.path.exists(p)]
        if not todo:
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
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
            lib = _libs[source] = ctypes.CDLL(_library_path(source))
        return lib
