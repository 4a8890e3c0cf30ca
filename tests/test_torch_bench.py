"""The port's bench (videoquery_torch/tools/bench.py) against bench.py and
the JAX package, on the CPU at small sizes (the kernels' plain versions).

- its textured frames equal bench.py's byte for byte from the same
  generator;
- each mode emits exactly bench.py's metric names (read from bench.py's
  AST), plus only the ``_n`` and ``_p90`` siblings and the three the port
  adds (the pinned copy rate, the 100k full-download round and the
  extraction's per-batch latency), and every mode's checks pass;
- a round selects the same clips, with the same HyperParams (rel 1e-6, as
  tests/test_torch_engine.py), as the JAX SearchEngine on the same index,
  targets and labels, resident and downloaded;
- the query's plain top-k values equal the JAX ``_local_query``'s on the
  same inputs (rtol 1e-5), and where a value is untied its id too;
- the ingest tree loads into the same features as the JAX ``load_index``;
- the extraction's bf16 batch is within the JAX criterion (0.1) of f32;
- a failed check makes the exit code 1; a CUDA device raises here; the
  module imports no torch at its top.
"""

import ast
import json
import math
import os
import random
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from videoquery.index.store import FeatureIndex as JaxIndex
from videoquery.search import engine as jax_engine
from videoquery.search.distributed import _local_query
from videoquery.search.selection import select_clips_to_review as jax_select
from videoquery.service.loader import load_index as jax_load_index
from videoquery_torch.core.config import HyperParams
from videoquery_torch.kernels.query import fused_query_topk
from videoquery_torch.search.engine import SearchEngine
from videoquery_torch.service.loader import load_index
from videoquery_torch.tools import bench

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GEOMETRY = ["--ticks", "3", "--splits", "1", "--resize", "96", "64", "--crop", "64"]
EXTRACT = ["--batch_clips", "1", "--batches", "1", "--frames", "30", "--hw", "64", "88",
           *GEOMETRY]
SIZES = {
    "round": ["--round_segments", "2048", "4096", "--dim", "64"],
    "query": ["--segments", "8192", "--dim", "64"],
    "extract": EXTRACT,
    "e2e": ["--batch_clips", "2", *GEOMETRY, "--e2e_size", "96", "64", "--fps", "5",
            "--clip_seconds", "2", "--e2e_frames", "24", "--e2e_long_frames", "44"],
    "ingest": ["--ingest_videos", "2", "--ingest_clips", "3", "--dim", "16"],
}
# what the port adds to bench.py's names beside the _n and _p90 siblings
PORT_NAMES = {"e2e": {"e2e_pinned_upload_mb_per_s"},
              "round": {"revise_round_p50_ms_100k_segments_download"},
              "extract": {"extraction_batch_p50_ms"}}


@pytest.fixture(scope="module")
def runs():
    """Each mode once, on the CPU at its small size, 3 repeats."""
    return {mode: bench.run(["--device", "cpu", "--mode", mode, "--repeats", "3"] + argv)
            for mode, argv in SIZES.items()}


def bench_py_names(mode: str, segments: int) -> set[str]:
    """The keys bench.py's main() assigns to metrics[...] in the block of
    ``mode`` (``if args.mode in (mode, ...)``), formatted where a key is an
    expression of args."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    args = SimpleNamespace(segments=segments)
    names = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and isinstance(node.test.comparators[0], ast.Tuple)):
            continue
        if node.test.comparators[0].elts[0].value != mode:
            continue
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Subscript) and isinstance(sub.ctx, ast.Store)
                    and isinstance(sub.value, ast.Name) and sub.value.id == "metrics"):
                names.add(eval(compile(ast.Expression(sub.slice), "bench.py", "eval"),
                               {"args": args}))
    return names


def test_textured_frames_equal_bench_py():
    for seed in (0, 3):
        want = jax_bench._textured_motion_frames(2, 6, 64, 96, np.random.default_rng(seed))
        got = bench._textured_motion_frames(2, 6, 64, 96, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(bench.extraction_frames("textured", 2, 6, (65, 97), 2, 0),
                          jax_bench._textured_motion_frames(2, 6, 64, 96,
                                                            np.random.default_rng(0)))


@pytest.mark.parametrize("mode", sorted(SIZES))
def test_mode_emits_bench_py_names_and_passes_its_checks(runs, mode):
    out = runs[mode]
    assert out["ok"] and out["rehearsal"] and out["device"] == {"type": "cpu"}
    assert out["vs_baseline"] is None and out["checks"][mode]
    assert all(v is True for v in out["checks"][mode].values()), out["checks"]
    segments = int(SIZES["query"][1])
    want = bench_py_names(mode, segments)
    assert want, mode
    base = want | PORT_NAMES.get(mode, set())
    got = set(out["metrics"])
    assert want <= got
    extras = got - base
    assert all(n.endswith(("_n", "_p90")) and n.rsplit("_", 1)[0] in base
               for n in extras), extras
    assert all(math.isfinite(v) for v in out["metrics"].values())
    assert out["metric"] == {"round": "revise_round_p50_over_100k_segments",
                             "query": f"query_p50_over_{segments}_segments",
                             "extract": "two_stream_extraction_throughput",
                             "e2e": "e2e_video_file_to_csvs_throughput",
                             "ingest": "csv_ingest_rows_per_sec"}[mode]


def test_a_failed_check_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(bench, "check_query",
                        lambda *a: {"kth_value": False, "max_abs_err": 0.0})
    argv = ["--device", "cpu", "--mode", "query", "--repeats", "2"] + SIZES["query"]
    assert bench.main(argv) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] is False and line["checks"]["query"] == {"kth_value": False}


def test_a_mode_never_resets_the_launch_counts(monkeypatch):
    """chip_smoke.py zeroes the wrappers' counts before the whole bench and
    reads them after: a mode reports differences and leaves them whole."""
    from videoquery_torch.kernels import query as k1

    monkeypatch.setattr(k1, "LAUNCHES", 7)
    out = bench.run(["--device", "cpu", "--mode", "query", "--repeats", "2"] + SIZES["query"])
    assert k1.LAUNCHES == 7 and out["launches"]["query"] == {"K1": 0}


def test_p90_only_from_100_samples():
    metrics = {}
    bench.put(metrics, "a", range(99))
    bench.put(metrics, "b", range(100), 0.5)
    assert metrics == pytest.approx({"a": 49.0, "a_n": 99, "b": 24.75, "b_n": 100,
                                     "b_p90": 44.55}, rel=1e-12)


def _jax_round(index, targets, labels, resident):
    """bench.py's one_round (bench.py:568-600) on the JAX package."""
    from videoquery.core.config import HyperParams as JaxHP

    hp = JaxHP()
    eng = jax_engine.SearchEngine(index)

    def select(scores, h):
        return jax_select(scores, {}, 1, h.threshold, 20, hp.near_miss_default,
                          rng=random.Random(42))

    tables = eng.compute_similarities_multi(targets, resident=resident)
    if resident and len(targets) > 1:
        hps = [h for h, _ in jax_engine.optimize_many(tables, labels, hp)]
        specs = [{"weights": h.weights, "threshold": h.threshold,
                  "near_miss": hp.near_miss_default, "keep_ids": [1],
                  "user_match_ids": [], "finalize": False} for h in hps]
        scores = jax_engine.round_scores_many(tables, specs)
        return hps, [select(sc if sc is not None else t.to_table().scores(h.weights), h)
                     for t, h, sc in zip(tables, hps, scores)]
    hps, picks = [], []
    for tbl, lab in zip(tables, labels):
        h, _ = tbl.optimize(lab, hp)
        scores = (tbl.round_scores(h.weights, h.threshold, hp.near_miss_default,
                                   keep_ids=[1]) if resident else tbl.scores(h.weights))
        hps.append(h)
        picks.append(select(scores, h))
    return hps, picks


@pytest.mark.parametrize("resident", [False, True])
def test_round_selects_as_the_jax_engine(resident):
    n, q = 2048, 2
    index = bench.round_index(n, "float32", 0, CPU)
    targets, labels = bench.round_queries(n, q, 0)
    _, hps, picks = bench.revise_round(SearchEngine(index), targets, labels, resident)
    jax_index = JaxIndex(index.clip_ids, jnp.asarray(index.feats.numpy()),
                         jnp.asarray(index.mask.numpy()), index.streams, index.splits,
                         index.feature_name)
    want_hps, want_picks = _jax_round(jax_index, targets, labels, resident)
    stream = HyperParams().streams[1]
    for h, w, p, wp in zip(hps, want_hps, picks, want_picks):
        assert math.isclose(h.threshold, w.threshold, rel_tol=1e-6)
        assert math.isclose(h.weights[stream], w.weights[stream], rel_tol=1e-6)
        assert p and list(p) == list(wp)
        np.testing.assert_allclose(list(p.values()), list(wp.values()), rtol=1e-6)


def test_query_plain_topk_equals_jax_local_query():
    k = 20
    world = bench.query_world(2048, 16, 0, CPU, dim=64)
    vals, ids = fused_query_topk(*world, k=k + 1)
    feats, mask, targets, tmask, weights = (
        jnp.asarray(t.float().numpy()) if t.dtype != torch.bool else jnp.asarray(t.numpy())
        for t in world)
    want_vals, want_ids = _local_query(feats.astype(jnp.bfloat16), mask, targets, tmask,
                                       weights, k=k + 1)
    want_vals, want_ids = np.asarray(want_vals), np.asarray(want_ids)
    np.testing.assert_allclose(vals.numpy(), want_vals, rtol=1e-5)
    gaps = np.abs(np.diff(want_vals, axis=1)) > 1e-5 * np.abs(want_vals[:, 1:])
    untied = gaps[:, :-1] & gaps[:, 1:]          # positions 1..k-1, both neighbours apart
    assert untied.any()
    np.testing.assert_array_equal(ids.numpy()[:, 1:k][untied], want_ids[:, 1:k][untied])
    check = bench.check_query(world, *fused_query_topk(*world, k=k), k)
    assert check.pop("max_abs_err") == 0.0 and all(check.values())


def test_ingest_tree_loads_as_the_jax_loader(tmp_path):
    root = str(tmp_path / "feats")
    assert bench.write_ingest_tree(root, 2, 3, 16, 0) == 36
    got = load_index(root, feature_dim=16, device="cpu")
    want = jax_load_index(root, feature_dim=16)
    assert got.n_clips == want.n_clips == 6
    np.testing.assert_array_equal(got.clip_ids, want.clip_ids)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.feats.numpy(), np.asarray(want.feats))


def test_extract_bf16_within_the_criterion_of_f32(runs):
    for kind in ("textured", "noise"):
        crit = runs["extract"]["extract"][kind]["bf16_criterion"]
        assert 0 < crit < bench.BF16_CRITERION


def test_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["--device", "cuda", "--mode", "query"], ["--mode", "query"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.run(argv + SIZES["query"])


def test_module_top_imports_no_torch():
    """A spawned decode producer imports this module (and the port's decode)
    and must not pay for torch."""
    code = ("import sys, videoquery_torch.tools.bench, videoquery_torch.pipeline.decode\n"
            "assert 'torch' not in sys.modules and 'jax' not in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


def test_chip_smoke_holds_every_bench_py_name():
    """chip_smoke.py's phase 16 fails unless these names are present: they
    are bench.py's, at its default --segments."""
    import chip_smoke

    want = set().union(*(bench_py_names(m, 1_000_000)
                         for m in ("extract", "e2e", "query", "round", "ingest")))
    assert set(chip_smoke.BENCH_PY_METRICS) == want
    assert len(chip_smoke.BENCH_PY_METRICS) == len(want)
