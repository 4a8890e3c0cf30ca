"""The port installed from its wheel, held on the CPU: tests/test_packaging.py's
offline recipe for ``videoquery_torch``, and a lint of its deploy images
(``deploy/torch/``).

``videoquery_torch/testing/installed.py`` builds the wheel from a temporary
copy of the sources (the JAX packaging test builds in the checkout itself,
on another test worker), installs it into a fresh venv and makes its
site-packages read-only. Every child runs outside the checkout with
``VIDEOQUERY_DEVICE=cpu``, ``-B``, ``HOME`` and ``XDG_CACHE_HOME`` in the
test's temporary directory, behind the import blocker that refuses jax and
the JAX package, and must leave site-packages' file list as it was.
"""

import json
import os
import re
import subprocess
import textwrap
import zipfile

import pytest
import yaml

from videoquery_torch.testing import installed as inst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "features", "stock-video-clips_features")
KERNEL_SOURCES = ("add_norm.cu", "inception_block.cu", "max_pool3d.cu", "query_kernel.cu",
                  "roll.cu", "stem_conv3d.cu", "tvl1_level.cu", "window_attention.cu",
                  "window_warp.cu")


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """(venv python, its site-packages, the wheel, the children's home)."""
    tmp = tmp_path_factory.mktemp("torchpkg")
    py, site, wheel = inst.install(REPO, str(tmp))
    home = tmp / "home"
    home.mkdir()
    yield py, site, wheel, str(home)
    inst.make_writable(site)


def run_installed(installed, code, cwd, env=None, timeout=180):
    """`code` in the venv after the import blocker; site-packages must hold
    the same files after it as before."""
    py, site, _wheel, home = installed
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS",
                              "VIDEOQUERY_TORCH_BUILD_DIR")}
    # two intra-op threads, as the other port tests: tier-1 runs 6 test
    # workers on 8 CPUs beside timing tests
    child_env.update(VIDEOQUERY_DEVICE="cpu", PYTHONDONTWRITEBYTECODE="1", HOME=home,
                     XDG_CACHE_HOME=os.path.join(home, "xdg"), COMPUTE_EPS="1e-6",
                     OMP_NUM_THREADS="2")
    child_env.update(env or {})             # a None drops the variable
    child_env = {k: v for k, v in child_env.items() if v is not None}
    before = inst.file_tree(site)
    r = subprocess.run([py, "-B", "-c", inst.BLOCKER + textwrap.dedent(code)], cwd=str(cwd),
                       env=child_env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    assert inst.file_tree(site) == before, sorted(inst.file_tree(site) ^ before)
    return r


def test_wheel_holds_the_kernel_sources(installed):
    with zipfile.ZipFile(installed[2]) as whl:
        names = set(whl.namelist())
    for source in KERNEL_SOURCES:
        assert f"videoquery_torch/kernels/csrc/{source}" in names, source


def test_the_blocker_refuses_jax_and_the_jax_package(installed, tmp_path):
    r = run_installed(installed, """
        for name in ("jax", "videoquery", "videoquery.service"):
            try:
                __import__(name)
            except ImportError as exc:
                assert "the installed port imported" in str(exc), exc
            else:
                raise AssertionError(name + " imported")
        print("blocked")
    """, tmp_path)
    assert "blocked" in r.stdout


def test_installed_port_builds_outside_site_packages(installed, tmp_path):
    """videoquery_torch resolves from site-packages; its kernel build
    directory is the user cache (XDG, else ~/.cache), or the override; a
    build creates that directory and nothing under site-packages (no nvcc
    here: the build stops there)."""
    _py, site, _wheel, home = installed
    code = """
        import json, os
        import videoquery_torch
        from videoquery_torch.kernels import _build
        out = {"file": videoquery_torch.__file__, "dir": _build.build_dir()}
        try:
            _build.build(["roll.cu"])
        except RuntimeError as exc:
            assert "nvcc" in str(exc), exc
        out["made"] = os.path.isdir(out["dir"])
        print(json.dumps(out))
    """
    for env, want in (({}, os.path.join(home, "xdg", "videoquery_torch", "kernels")),
                      ({"XDG_CACHE_HOME": None},
                       os.path.join(home, ".cache", "videoquery_torch", "kernels")),
                      ({"VIDEOQUERY_TORCH_BUILD_DIR": str(tmp_path / "kernels")},
                       str(tmp_path / "kernels"))):
        got = json.loads(run_installed(installed, code, tmp_path, env).stdout.splitlines()[-1])
        assert got["file"] == os.path.join(site, "videoquery_torch", "__init__.py")
        assert got["dir"] == want and got["made"], got


def test_installed_broker_processes_the_fixture_round(installed, tmp_path):
    """The fixture CSVs through the installed loader into the installed
    FakeAPI, then one new-query poll of the installed compute_matches on the
    CPU: state processed, a query result and match rows."""
    r = run_installed(installed, f"""
        import sys
        from videoquery_torch.core.config import HyperParams, STATE_PROCESSED
        from videoquery_torch.service.compute_matches import compute_matches
        from videoquery_torch.service.loader import DBLoader
        from videoquery_torch.service.repository import APIRepository
        from videoquery_torch.testing.fake_api import FakeAPI, FakeClient

        api = FakeAPI()
        n_rows = DBLoader(FakeClient(api)).load_tree({FIXTURE!r})
        clip_ids = sorted(api.video_clips)
        search = api.add_search_set("all", clip_ids)
        q = api.add_query("q1", next(iter(api.videos)), 1, clip_ids[0], search["id"],
                          max_matches_for_review=10)
        compute_matches(APIRepository(FakeClient(api), "fake://"), HyperParams(), seed=42,
                        report_dir="reports")
        assert api.queries[q["id"]]["process_state"] == STATE_PROCESSED, api.queries[q["id"]]
        assert any(r["query"] == q["id"] for r in api.query_results.values())
        assert api.matches, "no match rows written"
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "videoquery")]
        print("broker ok:", n_rows, "rows,", len(api.matches), "matches")
    """, tmp_path)
    assert "broker ok" in r.stdout


def test_installed_extraction_cli_on_synthetic_video(installed, tmp_path):
    """python -m videoquery_torch.pipeline.extract from the venv on a tiny
    synthetic video (test_packaging.py's geometry) writes the two
    reference-format CSVs."""
    pytest.importorskip("cv2")
    r = run_installed(installed, """
        import os, runpy, sys
        import cv2, numpy as np
        w = cv2.VideoWriter("synth.mp4", cv2.VideoWriter_fourcc(*"mp4v"), 5, (96, 72))
        img = np.random.default_rng(0).uniform(0, 255, (72, 96, 3)).astype(np.uint8)
        for i in range(25):
            w.write(cv2.warpAffine(img, np.float32([[1, 0, 0.6 * i], [0, 1, 0]]), (96, 72)))
        w.release()
        sys.argv = ["extract", "synth.mp4", "--out", "out", "--fps", "5", "--clip_time", "4",
                    "--num_ticks", "3", "--splits", "1"]
        runpy.run_module("videoquery_torch.pipeline.extract", run_name="__main__")
        csvs = sorted(f for _d, _s, fs in os.walk("out") for f in fs if f.endswith(".csv"))
        assert csvs == ["rgb_global_pool_features.csv",
                        "warped_optical_flow_global_pool_features.csv"], csvs
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "videoquery")]
        print("extract ok")
    """, tmp_path, timeout=300)
    assert "extract ok" in r.stdout


def dockerfile(name: str) -> str:
    with open(os.path.join(REPO, "deploy", "torch", name)) as f:
        return f.read()


@pytest.mark.parametrize("name,kernels", [("Dockerfile.broker", True),
                                          ("Dockerfile.extract", True),
                                          ("Dockerfile.load_db", False)])
def test_deploy_image_lint(name, kernels):
    """Each image copies videoquery_torch and installs the project; no pip
    line names jax; its entry point is a module of the port; broker and
    extract set the kernel build directory and prebuild into it; load_db
    runs on the CPU."""
    text = dockerfile(name)
    lines = [ln.strip() for ln in text.splitlines() if ln.strip() and not ln.startswith("#")]
    assert "COPY videoquery_torch ./videoquery_torch" in lines
    assert not any(ln.startswith("COPY videoquery ") for ln in lines)
    assert any(re.fullmatch(r"RUN pip install .*--no-deps \.", ln) for ln in lines)
    for ln in lines:
        if "pip install" in ln:
            assert not re.search(r"\bjax", ln), ln
    entry = json.loads(next(ln for ln in lines if ln.startswith("ENTRYPOINT"))[len("ENTRYPOINT"):])
    assert entry[:2] == ["python", "-m"] and entry[2].startswith("videoquery_torch."), entry
    assert os.path.exists(os.path.join(REPO, *entry[2].split(".")) + ".py"), entry
    env_at = [i for i, ln in enumerate(lines) if ln.startswith("ENV VIDEOQUERY_TORCH_BUILD_DIR=/")]
    run_at = [i for i, ln in enumerate(lines)
              if ln == "RUN python -m videoquery_torch.kernels._build"]
    if kernels:
        assert lines[0].startswith("FROM nvidia/cuda:12.8") and "devel" in lines[0]
        assert env_at and run_at and env_at[0] < run_at[0], (env_at, run_at)
    else:
        assert not env_at and not run_at
        assert any(ln.startswith("ENV ") and "VIDEOQUERY_DEVICE=cpu" in ln for ln in lines)
        assert not any("cu128" in ln for ln in lines)


def test_deploy_compose_names_existing_dockerfiles_and_reserves_gpus():
    with open(os.path.join(REPO, "deploy", "torch", "docker-compose.yml")) as f:
        compose = yaml.safe_load(f)
    services = compose["services"]
    assert set(services) == {"broker", "load_db", "extract"}
    for name, svc in services.items():
        ctx = os.path.normpath(os.path.join(REPO, "deploy", "torch", svc["build"]["context"]))
        assert ctx == REPO
        assert os.path.exists(os.path.join(ctx, svc["build"]["dockerfile"])), name
        assert svc["build"]["dockerfile"] == f"deploy/torch/Dockerfile.{name}"
        gpus = [d for d in (svc.get("deploy", {}).get("resources", {})
                            .get("reservations", {}).get("devices", []))
                if "gpu" in d.get("capabilities", [])]
        assert bool(gpus) == (name != "load_db"), name
