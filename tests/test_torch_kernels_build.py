"""Where the port's kernels are built (videoquery_torch/kernels/_build.py),
held on the CPU without nvcc: the override, the checkout and the user
cache in that order, a read-only checkout falling to the cache, a chosen
directory that cannot be made raising with its path, the prebuild command,
and the library names of unchanged sources (so a checkout's existing
builds are reused)."""

import hashlib
import os
import subprocess
import sys

import pytest

from videoquery_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the flags every earlier build of the port was named with
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")
SOURCES = ("add_norm.cu", "inception_block.cu", "max_pool3d.cu", "query_kernel.cu",
           "roll.cu", "stem_conv3d.cu", "tvl1_level.cu", "window_attention.cu",
           "window_warp.cu")


def library_name(source: str) -> str:
    with open(os.path.join(REPO, "videoquery_torch", "kernels", "csrc", source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return f"lib{os.path.splitext(source)[0]}_{digest}.so"


def package_at(root) -> str:
    pkg = os.path.join(str(root), "videoquery_torch")
    os.makedirs(pkg)
    return pkg


@pytest.mark.parametrize("where", ["checkout", "site-packages", "dist-packages"])
def test_override_then_checkout_then_cache(tmp_path, where):
    parent = tmp_path / ("src" if where == "checkout" else f"lib/python3.12/{where}")
    pkg = package_at(parent)
    home, xdg = str(tmp_path / "home"), str(tmp_path / "xdg")
    override = str(tmp_path / "kernels")
    assert _build.resolve_build_dir({_build.BUILD_DIR_ENV: override, "HOME": home,
                                     "XDG_CACHE_HOME": xdg}, pkg) == override
    got = _build.resolve_build_dir({"HOME": home, "XDG_CACHE_HOME": xdg}, pkg)
    if where == "checkout":
        assert got == os.path.join(str(parent), "build", "videoquery_torch_kernels")
    else:
        assert got == os.path.join(xdg, "videoquery_torch", "kernels")
        assert _build.resolve_build_dir({"HOME": home}, pkg) == os.path.join(
            home, ".cache", "videoquery_torch", "kernels")


def test_read_only_checkout_selects_the_cache(tmp_path, monkeypatch):
    parent = tmp_path / "src"
    pkg = package_at(parent)
    env = {"HOME": str(tmp_path / "home")}
    assert _build.resolve_build_dir(env, pkg).startswith(str(parent))
    real_access = os.access
    # root writes through a mode of 0o555, so the check is also told so
    monkeypatch.setattr(_build.os, "access", lambda p, mode: False if (
        os.path.abspath(p) == str(parent) and mode == os.W_OK) else real_access(p, mode))
    os.chmod(parent, 0o555)
    try:
        assert _build.resolve_build_dir(env, pkg) == os.path.join(
            str(tmp_path / "home"), ".cache", "videoquery_torch", "kernels")
    finally:
        os.chmod(parent, 0o755)


def test_this_checkout_builds_beside_the_package():
    assert _build.resolve_build_dir({}, os.path.join(REPO, "videoquery_torch")) == \
        os.path.join(REPO, "build", "videoquery_torch_kernels")


@pytest.mark.parametrize("source", SOURCES)
def test_library_names_of_unchanged_sources(source):
    """name = lib<stem>_<sha256(source + flags)[:16]>.so, as every earlier
    build was named."""
    assert _build.NVCC_FLAGS == FLAGS
    assert source in _build.sources()
    path = _build.library_path(source)
    assert os.path.basename(path) == library_name(source)
    assert os.path.dirname(path) == _build.build_dir()


def test_a_directory_that_cannot_be_made_raises_with_its_path(tmp_path, monkeypatch):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    chosen = str(blocker / "kernels")
    monkeypatch.setattr(_build, "_build_dir", chosen)
    with pytest.raises(RuntimeError, match=chosen):
        _build.build(["roll.cu"])
    assert _build.main() == 1


def test_an_unwritable_directory_raises_with_its_path(tmp_path, monkeypatch):
    chosen = str(tmp_path / "kernels")
    os.makedirs(chosen)
    monkeypatch.setattr(_build, "_build_dir", chosen)
    real_access = os.access
    monkeypatch.setattr(_build.os, "access", lambda p, mode: False if (
        p == chosen and mode == os.W_OK) else real_access(p, mode))
    with pytest.raises(RuntimeError, match="not writable") as exc:
        _build.build(["roll.cu"])
    assert chosen in str(exc.value)


def test_prebuild_command_reuses_libraries_in_the_override(tmp_path):
    """python -m videoquery_torch.kernels._build with every library present
    in $VIDEOQUERY_TORCH_BUILD_DIR compiles nothing (no nvcc here) and
    lists each one; with the directory impossible to make it exits 1."""
    kernels = tmp_path / "kernels"
    kernels.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, **{_build.BUILD_DIR_ENV: str(kernels)})
    for source in SOURCES:
        (kernels / library_name(source)).write_bytes(b"")
    cmd = [sys.executable, "-m", "videoquery_torch.kernels._build"]
    r = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == f"kernel build directory: {kernels}"
    assert [ln.split(":")[0] for ln in lines[1:]] == list(SOURCES)
    assert all(ln.endswith("(reused)") for ln in lines[1:])
    (tmp_path / "a_file").write_text("")
    env[_build.BUILD_DIR_ENV] = str(tmp_path / "a_file" / "kernels")
    r = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1
    assert str(tmp_path / "a_file" / "kernels") in r.stderr
    assert r.stdout.count("(FAILED)") == len(SOURCES)
