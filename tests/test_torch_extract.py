"""The port's extraction slice (videoquery_torch.pipeline.extract) end to end
against the JAX package, and into the port's loader and broker.

A small extractor (64 px crops, 3 ticks, one split, production TVL1 on a
32x48 flow grid) runs on the same synthetic frames in both packages; the
JAX one takes its pair path (flow_impl="pallas") under interpret mode, the
oracle the port mirrors, with the same weights (from_jax_params).
Tolerances:
- clip numbers, CSV file layout and headers: equal;
- quantized flow: within 1 LSB everywhere (>= 99.9% of bytes equal);
- rgb embeddings: rtol 1e-4 / atol 1e-5 (BN-Inception in f32);
- flow embeddings: rtol 1e-4 / atol 1e-5, held also when a few quantized
  bytes differ by one LSB (measured here: 2 of 110,592 bytes differ and the
  flow embeddings are at most 2.2e-7 apart);
- with bf16 networks (dtype="bfloat16" in both packages): mean |port - JAX|
  / mean |JAX| < 2% for each stream (the two round the same values at the
  same places but sum in another order; see test_torch_nn.py), and against
  the port's f32 signatures the JAX package's own criterion, < 10%.
"""

import ast
import glob
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videoquery.core.config import ExtractionConfig as JaxExtractionConfig
from videoquery.nn.tsn import TwoStreamTSN as JaxTSN
from videoquery.pipeline import extract as je
from videoquery.testing.fake_api import FakeAPI, FakeClient
from videoquery_torch.core.config import (STATE_PROCESSED, ExtractionConfig,
                                          HyperParams)
from videoquery_torch.index.csvio import read_features_csv
from videoquery_torch.nn.tsn import TwoStreamTSN
from videoquery_torch.pipeline import extract as te
from videoquery_torch.service.compute_matches import compute_matches
from videoquery_torch.service.loader import DBLoader
from videoquery_torch.service.repository import APIRepository
from videoquery_torch.testing.fake_api import FakeAPI as PortFakeAPI
from videoquery_torch.testing.fake_api import FakeClient as PortFakeClient

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(fps=5, clip_seconds=2, num_ticks=3, frame_resize=(96, 64), crop_size=64,
           batch_clips=2, min_tail_seconds=1, decode_at_target=False)


def synthetic_frames(n=26, h=64, w=96, seed=0):
    """BGR uint8 [n, h, w, 3]: pan + zoom of a blurred texture and a moving
    bright square (2 full 10-frame clips + a 6-frame tail at fps 5)."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 255, (h * 2, w * 2, 3), np.uint8), (9, 9), 3)
    out = []
    for i in range(n):
        z = 1.0 + 0.01 * i
        m = np.float32([[z, 0, -10 - 2 * i], [0, z, -8 - i]])
        fr = cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_REFLECT)
        fr[20:30, 10 + 3 * i:20 + 3 * i] = (230, 240, 250)
        out.append(fr)
    return np.stack(out)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(jax extractor, its signatures, port extractor, its signatures)."""
    frames = synthetic_frames()
    jtsn = JaxTSN.random(jax.random.PRNGKey(0), splits=(1,))
    unstack = lambda st: {1: jax.tree.map(lambda a: np.asarray(a[0]), st)}  # noqa: E731
    ptsn = TwoStreamTSN.from_jax_params(unstack(jtsn.rgb.stacked_params),
                                        unstack(jtsn.flow.stacked_params), device="cpu")
    jex = je.Extractor(jtsn, JaxExtractionConfig(**CFG), warped=True,
                       flow_impl="pallas")
    with pltpu.force_tpu_interpret_mode():
        jsigs = je.gather_signatures(list(jex.extract_frames(frames)))
    pex = te.Extractor(ptsn, ExtractionConfig(**CFG), warped=True, device="cpu")
    psigs = te.gather_signatures(list(pex.extract_frames(frames)))
    return frames, jex, jsigs, pex, psigs


@pytest.fixture(scope="module")
def both_bf16(both):
    """(JAX signatures, port signatures) of the same frames with bf16
    networks, same weights as `both`."""
    frames, jex, _jsigs, pex, _psigs = both
    jex16 = je.Extractor(jex.tsn, JaxExtractionConfig(**CFG), warped=True,
                         flow_impl="pallas", dtype="bfloat16")
    with pltpu.force_tpu_interpret_mode():
        jsigs = je.gather_signatures(list(jex16.extract_frames(frames)))
    pex16 = te.Extractor(pex.tsn, ExtractionConfig(**CFG), warped=True, device="cpu",
                         dtype="bfloat16")
    return jsigs, te.gather_signatures(list(pex16.extract_frames(frames)))


def mean_rel(got, want) -> float:
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def test_bf16_signatures_match_jax_bf16(both, both_bf16):
    _frames, _jex, _jsigs, _pex, psigs32 = both
    jsigs, psigs = both_bf16
    assert [s.clip_numbers for s in psigs] == [s.clip_numbers for s in jsigs]
    for js, ps, p32 in zip(jsigs, psigs, psigs32):
        for attr in ("rgb", "flow"):
            got = getattr(ps, attr)
            assert got.dtype == np.float32 and got.shape == getattr(p32, attr).shape
            assert mean_rel(got, np.asarray(getattr(js, attr), np.float32)) < 0.02
            assert mean_rel(got, getattr(p32, attr)) < 0.1


def quantized_flow_both(frames, jex, pex, group):
    """u8 [B, P, fh, fw, 2] of one batch from each package."""
    clip = np.stack([frames[s - 1:e] for s, e in group])
    f_len = clip.shape[1]
    _t, _ti, _st, pair_dev, warm = jex._plan_arrays(f_len)
    pair_flow = jax.jit(je._pair_flow, static_argnames=(
        "bound", "warped", "tvl1", "value_scale", "warm_camera"))
    with pltpu.force_tpu_interpret_mode():
        gray, vs = je._flow_gray_grid(jnp.asarray(clip), 2)
        want = np.asarray(pair_flow(gray, pair_dev, bound=20.0, warped=True,
                                    tvl1=jex.tvl1, value_scale=vs, warm_plan=warm,
                                    warm_camera="init"))
    plan = pex._plan(f_len)
    gray_t, vs_t = te._flow_gray_grid(torch.from_numpy(clip), 2)
    got = te._pair_flow(gray_t, plan.pair_idx, 20.0, True, pex.tvl1, vs_t, plan.warm,
                        "init").numpy()
    return got, want


def test_clip_numbers_and_embeddings_match_jax(both):
    frames, jex, jsigs, pex, psigs = both
    assert [s.clip_numbers for s in psigs] == [s.clip_numbers for s in jsigs] == [[1, 2], [3]]
    for js, ps in zip(jsigs, psigs):
        assert ps.rgb.shape == js.rgb.shape == (1, len(js.clip_numbers), 1024)
        np.testing.assert_allclose(ps.rgb, js.rgb, rtol=1e-4, atol=1e-5)
    # the full-clip batch's quantized flow, then its flow embeddings
    got, want = quantized_flow_both(frames, jex, pex, [(1, 10), (11, 20)])
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    for js, ps in zip(jsigs, psigs):
        np.testing.assert_allclose(ps.flow, js.flow, rtol=1e-4, atol=1e-5)


def test_csv_tree_matches_jax_layout(both, tmp_path):
    _frames, jex, jsigs, pex, psigs = both
    jp = jex.write_csv_tree(jsigs, str(tmp_path / "jax"), "vid", "http://x/vid.mp4")
    pp = pex.write_csv_tree(psigs, str(tmp_path / "port"), "vid", "http://x/vid.mp4")
    rel = lambda paths, root: [os.path.relpath(p, root) for p in paths]  # noqa: E731
    assert rel(pp, tmp_path / "port") == rel(jp, tmp_path / "jax")
    for a, b in zip(pp, jp):
        with open(a) as fa, open(b) as fb:
            assert fa.readline() == fb.readline()          # provenance header
        ca, cb = read_features_csv(a), read_features_csv(b)
        np.testing.assert_array_equal(ca.clip_numbers, cb.clip_numbers)
        np.testing.assert_allclose(ca.features, cb.features, rtol=1e-4, atol=1e-5)


def test_port_csvs_through_loader_and_broker(both, tmp_path):
    """The port's CSVs are the loader's input: ingest them and run a new
    round through the port's compute_matches to state 4 (processed)."""
    _frames, _jex, _jsigs, pex, psigs = both
    pex.write_csv_tree(psigs, str(tmp_path / "feats"), "vid", "http://x/vid.mp4")
    api = FakeAPI()
    n_rows = DBLoader(FakeClient(api)).load_tree(str(tmp_path / "feats"))
    assert n_rows == 3 * 2                      # 3 clips x 2 streams x 1 split
    clip_ids = sorted(api.video_clips)
    ref = next(c for c in clip_ids if api.video_clips[c]["clip"] == 1)
    search = api.add_search_set("all", clip_ids)
    q = api.add_query("q", next(iter(api.videos)), 1, ref, search["id"],
                      max_matches_for_review=2)
    compute_matches(APIRepository(FakeClient(api), "fake://"), HyperParams(), seed=42,
                    report_dir=str(tmp_path / "reports"), device="cpu")
    assert api.queries[q["id"]]["process_state"] == STATE_PROCESSED
    assert any(r["query"] == q["id"] for r in api.query_results.values())


def test_records_carry_both_streams(both):
    _frames, _jex, _jsigs, pex, psigs = both
    recs = pex.records(psigs)
    assert len(recs) == 3 * 2
    assert {(r.clip_id, r.stream) for r in recs} == {
        (c, s) for c in (1, 2, 3) for s in ("rgb", "warped_optical_flow")}


def test_cli_writes_csv_tree_on_cpu(tmp_path, monkeypatch):
    """python -m videoquery_torch.pipeline.extract on a short clip, on the
    CPU (VIDEOQUERY_DEVICE=cpu), production geometry (340x256 -> 128x128
    flow grid, 224 crops), one split."""
    from videoquery_torch.pipeline import decode

    video = str(tmp_path / "clip.mp4")
    decode.synthesize_video(video, n_frames=20, size=(160, 120))
    monkeypatch.setenv("VIDEOQUERY_DEVICE", "cpu")
    te.main([video, "--out", str(tmp_path / "out"), "--splits", "1", "--num_ticks", "3",
             "--fps", "5", "--clip_time", "2", "--batch_clips", "2"])
    tree = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "out")
                  for d, _, fs in os.walk(tmp_path / "out") for f in fs)
    assert tree == ["clip/UCF101_split1/rgb_global_pool_features.csv",
                    "clip/UCF101_split1/warped_optical_flow_global_pool_features.csv"]
    csv = read_features_csv(str(tmp_path / "out" / tree[1]))
    assert csv.clip_numbers.tolist() == [1, 2] and csv.features.shape == (2, 1024)
    assert np.isfinite(csv.features).all()


def test_cli_bf16_csvs_ingest_and_meet_the_bf16_criterion(tmp_path, monkeypatch):
    """python -m videoquery_torch.pipeline.extract synthetic --dtype bfloat16
    (small geometry, on the CPU): the port's loader ingests the CSV tree, and
    each file's vectors are within the JAX package's bf16 criterion of an
    f32 run's."""
    monkeypatch.setenv("VIDEOQUERY_DEVICE", "cpu")
    args = ["--splits", "1", "--num_ticks", "3", "--fps", "5", "--clip_time", "20",
            "--batch_clips", "2", "--new_width", "160", "--new_height", "120"]
    te.main(["synthetic", "--out", str(tmp_path / "f32"), *args])
    te.main(["synthetic", "--out", str(tmp_path / "bf16"), *args, "--dtype", "bfloat16"])
    paths = sorted(glob.glob(str(tmp_path / "bf16" / "_synthetic" / "*" / "*.csv")))
    assert len(paths) == 2
    for path in paths:
        got = read_features_csv(path)
        want = read_features_csv(path.replace(str(tmp_path / "bf16"), str(tmp_path / "f32")))
        np.testing.assert_array_equal(got.clip_numbers, want.clip_numbers)
        assert np.isfinite(got.features).all()
        assert mean_rel(got.features, want.features) < 0.1
    api = PortFakeAPI()
    n_rows = DBLoader(PortFakeClient(api)).load_tree(str(tmp_path / "bf16"))
    assert n_rows == len(read_features_csv(paths[0]).clip_numbers) * 2
    with pytest.raises(SystemExit):
        te.main(["synthetic", "--out", str(tmp_path / "x"), "--dtype", "float16"])


def test_extractor_refuses_what_is_not_ported():
    """What the port refuses: another blob than global_pool (it would label
    global_pool vectors wrongly), another working type, and compact uploads
    out of order (host crop without host gray), in the config and on the CLI
    before anything is written, and a flow solver by another name. The affine camera is no longer refused: an
    Extractor takes it (tests/test_torch_gather_tvl1.py holds its batch
    against the JAX package's)."""
    from videoquery_torch.kernels.tvl1 import TVL1Params

    tsn = TwoStreamTSN.random(0, splits=(1,), device="cpu")
    with pytest.raises(ValueError, match="host_crop requires host_gray"):
        ExtractionConfig(host_crop=True)
    with pytest.raises(ValueError):
        te.Extractor(tsn, ExtractionConfig(feature_blob="fc-action"), device="cpu")
    ex = te.Extractor(tsn, ExtractionConfig(), tvl1=TVL1Params(camera_model="affine"),
                      device="cpu")
    assert ex.tvl1.camera_model == "affine" and ex.flow_impl == "pallas"
    with pytest.raises(ValueError, match="host_yuv420 requires host_crop"):
        te.main(["synthetic", "--out", "unused", "--host_gray", "--host_yuv420"])
    assert not os.path.exists("unused")
    with pytest.raises(ValueError):
        te.Extractor(tsn, ExtractionConfig(), device="cpu", dtype="float16")
    # a flow solver by another name: the plan and the step refuse it too,
    # so a direct caller cannot index all-pairs flow with pair positions
    with pytest.raises(ValueError, match="flow_impl"):
        te.Extractor(tsn, ExtractionConfig(), device="cpu", flow_impl="gather")
    with pytest.raises(ValueError, match="flow_impl"):
        te.step_plan(20, ExtractionConfig(), "gather", "cpu")
    with pytest.raises(ValueError, match="flow_impl"):
        te.extract_step(tsn, torch.zeros((1, 20, 8, 8, 3), dtype=torch.uint8), None,
                        ExtractionConfig(), True, TVL1Params(), flow_impl="gather")


# the extraction measurement tools ported beside flow_quality
NEW_TOOLS = ("flow_bench", "warm_stages", "extract_stages", "pipeline_overlap",
             "tick_sweep", "parity_embeddings", "scaling_curve", "cnn_roofline", "bench",
             "dryrun")


def test_extraction_imports_without_jax():
    """Importing every module of the port, and the module of the `cuda`
    tests that runs on the card without jax (with its inputs' module
    ``tests/_torch_cases.py``), loads neither jax nor any
    module of the JAX package (videoquery.*) nor the repository's tools/
    nor its bench.py."""
    code = ("import sys, pkgutil, importlib, importlib.util, videoquery_torch\n"
            "for m in pkgutil.walk_packages(videoquery_torch.__path__, 'videoquery_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "sys.path.insert(0, 'tests')   # as pytest puts it there for the module\n"
            "spec = importlib.util.spec_from_file_location(\n"
            "    'cuda_tests', 'tests/test_torch_cuda_kernels.py')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'videoquery' or m.startswith('videoquery.')\n"
            "       or m == 'tools' or m.startswith('tools.') or m == 'bench']\n"
            "assert not bad, bad\n"
            "assert 'videoquery_torch.tools.inception_block_bench' in sys.modules\n"
            "assert 'videoquery_torch.tools.flow_quality' in sys.modules\n"
            f"for tool in {NEW_TOOLS!r}:\n"
            "    assert 'videoquery_torch.tools.' + tool in sys.modules, tool\n"
            "assert 'videoquery_torch.nn.prototxt_net' in sys.modules\n"
            "assert 'videoquery_torch.testing.caffe_wire' in sys.modules\n"
            "assert '_torch_cases' in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


def imported_modules(path: str) -> set[str]:
    """Every module a Python file imports, at any depth of its code."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


@pytest.mark.parametrize("where", ["chip_smoke.py", "videoquery_torch",
                                   "videoquery_torch/tools/flow_quality.py",
                                   "tests/test_torch_cuda_kernels.py", "tests/_torch_cases.py"]
                         + [f"videoquery_torch/tools/{t}.py" for t in NEW_TOOLS]
                         + ["videoquery_torch/nn/prototxt.py",
                            "videoquery_torch/nn/prototxt_net.py",
                            "videoquery_torch/testing/caffe_wire.py",
                            "videoquery_torch/testing/sharded_serving.py",
                            "videoquery_torch/kernels/_build.py"])
def test_port_sources_import_nothing_of_the_jax_package(where):
    """No import statement in chip_smoke.py, any module of the port, the
    module of the `cuda` tests or its inputs' module names jax, the JAX package (videoquery.*),
    the repository's tools/ or its bench.py."""
    root = os.path.join(REPO, where)
    files = ([root] if root.endswith(".py")
             else glob.glob(os.path.join(root, "**", "*.py"), recursive=True))
    assert files
    for path in files:
        for mod in imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "videoquery", "tools", "bench"), (path, mod)
