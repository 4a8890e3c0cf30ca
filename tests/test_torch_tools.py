"""The port's extraction measurement tools (videoquery_torch/tools/
{flow_bench,warm_stages,extract_stages,pipeline_overlap,tick_sweep,
parity_embeddings,scaling_curve}.py), each run in-process through its
``main`` at a tiny size on the CPU (the kernels' plain versions): it
returns, prints every row and its final JSON line. Beyond that:

- warm_stages' "full" row computes exactly ``_pair_flow_uv`` on the same
  pairs (warm g3, the key's camera): equal bit for bit;
- pipeline_overlap's B and C signatures equal A's bit for bit, batch by
  batch over two distinct frame sets (the tool raises otherwise);
- parity_embeddings' ``compare_trees`` gives the JAX tool's worst cosine
  on the same two CSV trees, and its ``--selftest`` passes;
- scaling_curve spawns Gloo worlds of 1 and 2 ranks;
- cnn_roofline's cost model equals the JAX tool's row for row but the stem
  (the port's plain 7x7/s2 conv, counted here independently), and its
  ceilings' code runs at a tiny size.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from videoquery_torch.pipeline import extract as te

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "features", "stock-video-clips_features")

# a tiny extraction batch for extract_stages and pipeline_overlap
TINY_BATCH = ["--device", "cpu", "--batch", "1", "--frames", "20", "--hw", "64", "96",
              "--ticks", "3", "--splits", "1", "--resize", "96", "64", "--crop", "64",
              "--dtype", "float32", "--reps", "1"]


def last_json(capsys, key):
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return lines, json.loads(lines[-1])[key]


def test_flow_bench(capsys):
    from videoquery_torch.tools import flow_bench

    flow_bench.main(["--device", "cpu", "--pairs", "4", "--hw", "32", "32", "--sweep", "4",
                     "2", "--levels", "--reps", "1"])
    lines, out = last_json(capsys, "flow_bench")
    names = [r["row"] for r in out["rows"]]
    assert names[:3] == ["camera estimate (coarse xcorr + 6 LK steps on K3)",
                         "camera warp (roll + K3, d=4)",
                         "pyramid on the warped pairs (K2, d=8)"]
    assert sum(n.startswith("warped flow") for n in names) == 2
    assert sum(n.strip().startswith("level") for n in names) == 4    # 2 levels x 2 sizes
    for r in out["rows"]:
        assert r["ms"] > 0 and any(ln.startswith(r["row"]) for ln in lines)
    flow_bench.main(["--device", "cpu", "--pairs", "4", "--hw", "32", "32", "--warm",
                     "--reps", "1"])
    _, out = last_json(capsys, "flow_bench")
    assert [r["warm_group"] for r in out["rows"]] == [0, 5, 3]


def test_timeit_returns_the_last_output():
    from videoquery_torch.tools.flow_bench import timeit

    calls = []
    sec, out = timeit(lambda x: calls.append(x) or torch.full((2,), float(len(calls))), 7,
                      reps=3)
    assert sec >= 0 and len(calls) == 4 and out.tolist() == [4.0, 4.0]


def test_warm_stages_full_is_pair_flow_uv(capsys):
    from videoquery_torch.tools import warm_stages

    argv = ["--device", "cpu", "--batch", "1", "--frames", "20", "--hw", "32", "32",
            "--ticks", "3", "--reps", "1"]
    out = warm_stages.run(argv)
    lines = capsys.readouterr().out.splitlines()
    assert [r["row"] for r in out["rows"]] == ["full", "cold", "key_solve", "cam_est",
                                               "cam_apply", "warm_solve", "gathers"]
    for r in out["rows"]:
        assert any(r["label"] in ln for ln in lines)
    assert any("=> accounted" in ln for ln in lines)
    gray = warm_stages.make_gray(1, 20, 32, 32, "cpu")
    pidx, warm = warm_stages.warm_plan(20, 3, 5, 3, "cpu")
    u, v = te._pair_flow_uv(gray, pidx, True, te.PRODUCTION_TVL1, warm, "key")
    got_u, got_v = out["outputs"]["full"]
    assert torch.equal(got_u, u) and torch.equal(got_v, v)
    warm_stages.main(argv)
    _, js = last_json(capsys, "warm_stages")
    assert "outputs" not in js and js["full_ms"] > 0


def test_extract_stages(capsys):
    from videoquery_torch.tools import extract_stages

    extract_stages.main(TINY_BATCH)
    lines, out = last_json(capsys, "extract_stages")
    assert [r["row"] for r in out["rows"]] == ["gray", "flow", "inputs", "cnn", "full"]
    for r in out["rows"]:
        assert r["ms"] > 0 and any(r["label"] in ln for ln in lines)
    assert [("delta_ms" in r) for r in out["rows"]] == [True, True, True, False, False]
    assert any("clips/s" in ln for ln in lines)


def test_pipeline_overlap_b_and_c_equal_a(capsys):
    from videoquery_torch.tools import pipeline_overlap

    pipeline_overlap.main(TINY_BATCH[:-1] + ["2"])
    lines, out = last_json(capsys, "pipeline_overlap")
    assert out["bitwise_equal_to_a"] == {"A": True, "B": True, "C": True,
                                         "batches_differ": True}
    assert set(out["ms"]) == {"A", "prep", "cnn", "B", "C"}
    for tag in ("A extract_step", "prep alone", "B prep[i+1]", "C prep[i+1]", "=> best"):
        assert any(tag in ln for ln in lines), tag


def test_tick_sweep(capsys):
    from videoquery_torch.tools import tick_sweep

    tick_sweep.main(["--device", "cpu", "--seeds", "0", "--ticks", "3", "2", "--frames", "12",
                     "--size", "48", "64", "--resize", "96", "64", "--crop", "64",
                     "--batch_clips", "1", "--bench_hw", "48", "64", "--bench_splits", "1",
                     "--bench_reps", "1"])
    lines, out = last_json(capsys, "tick_sweep")
    assert [r["ticks"] for r in out["rows"]] == [3, 2]
    for r in out["rows"]:
        assert 0.0 <= r["flow_retrieval"] <= 1.0 and r["clips_per_s"] > 0
        assert any(ln.startswith(f"{r['ticks']:5d}") for ln in lines)


def perturbed_copy(src, dst, seed=0):
    """The fixture tree with every feature row perturbed, written by the
    port's CSV writer."""
    from videoquery_torch.index.csvio import (list_feature_tree, read_features_csv,
                                              write_features_csv)

    rng = np.random.default_rng(seed)
    shutil.copytree(src, dst)
    for _video, _split, path in list_feature_tree(dst):
        csvf = read_features_csv(path)
        feats = csvf.features + rng.normal(size=csvf.features.shape) * 0.02
        write_features_csv(path, csvf.video, csvf.video_url, csvf.stream, csvf.feature_blob,
                           csvf.weights_uri, list(zip(csvf.clip_numbers, feats)))


def test_compare_trees_matches_jax(tmp_path, capsys):
    from tools import parity_embeddings as jpe
    from videoquery_torch.tools import parity_embeddings as pe

    got = str(tmp_path / "got")
    perturbed_copy(FIXTURE, got)
    worst = pe.compare_trees(got, FIXTURE)
    assert worst == jpe.compare_trees(got, FIXTURE)
    assert 0.9 < worst < 1.0
    assert pe.compare_trees(FIXTURE, FIXTURE) == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(SystemExit):
        pe.compare_trees(str(tmp_path / "got"), os.path.join(
            REPO, "tests", "data", "features", "SHRP2_Forward_clips_features"))


def test_parity_selftest(monkeypatch, capsys):
    from videoquery_torch.tools import parity_embeddings as pe

    monkeypatch.setenv("VIDEOQUERY_DEVICE", "cpu")
    pe.main(["--selftest", "--extract_args",
             "--num_ticks 2 --fps 5 --clip_time 20 --new_width 96 --new_height 64"])
    assert "[selftest] OK" in capsys.readouterr().out


def test_scaling_curve_spawns_gloo_worlds(capsys):
    from videoquery_torch.tools import scaling_curve

    scaling_curve.main(["--device", "cpu", "--ranks", "1", "2", "--batch_clips", "2",
                        "--frames", "10", "--hw", "32", "48", "--resize", "64", "48",
                        "--crop", "32", "--ticks", "5", "--splits", "1", "--tvl1", "modest",
                        "--reps", "1", "--diag"])
    lines, out = last_json(capsys, "scaling_curve")
    assert [r["ranks"] for r in out["rows"]] == [1, 2]
    for r in out["rows"]:
        for key in ("full_s", "cnn_s", "flow_s", "control_s"):
            assert r[key] > 0
    assert out["rows"][0]["speedup_vs_1"] == 1.0
    assert any("t(1)/t(2)" in ln for ln in lines)


@pytest.mark.parametrize("n", [200, 7])
@pytest.mark.parametrize("c", [3, 10])
def test_cnn_roofline_model_equals_the_jax_tools_but_the_stem(n, c):
    from tools import cnn_roofline as jroof
    from videoquery_torch.tools import cnn_roofline as roof

    ours, theirs = roof.model(n, c), jroof.model(n, c)
    assert len(ours) == len(theirs)
    assert ours[1:] == theirs[1:]
    # the stem: a 7x7 stride-2 conv of n x 224 x 224 x c to 112 x 112 x 64, bf16
    assert ours[0] == ("conv1/7x7_s2", 2 * n * 112 * 112 * 7 * 7 * c * 64,
                       n * 224 * 224 * c * 2, n * 112 * 112 * 64 * 2, 7 * 7 * c * 64 * 2)
    stem = sum(ours[0][2:])
    jax_stem = sum(theirs[0][2:])
    assert roof.ideal_bytes(ours) - stem == jroof.ideal_bytes(theirs) - jax_stem
    # f32: every byte count doubles, the FLOPs stay
    f32 = roof.model(n, c, nbytes=4)
    assert [r[1] for r in f32] == [r[1] for r in ours]
    assert roof.ideal_bytes(f32) == roof.ideal_bytes(ours) * 2 - n * 1024 * 4


def test_cnn_roofline_on_the_cpu(capsys):
    from videoquery_torch.tools import cnn_roofline as roof

    roof.main(["--device", "cpu", "--images", "2", "--splits", "1", "--reps", "1"])
    lines, res = last_json(capsys, "cnn_roofline")
    assert res["ceilings"] is None and res["dtype"] == "bfloat16"
    assert "[ceilings] not measured on cpu" in lines
    for stream in ("rgb", "flow"):
        s = res["streams"][stream]
        assert s["ms"] > 0 and s["bounds_measured"] is None
        assert s["gflop"] == pytest.approx(sum(v["gflop"] for v in s["blocks"].values()))
        assert 0 < s["bounds_nominal"]["ideal_ms"] < s["bounds_nominal"]["unfused_ms"]
        assert s["t1_gflop"] < s["gflop"]
    assert res["total"]["cnn_clips_s_8clip"] is None      # not 200 images


def test_cnn_roofline_ceilings_run_at_a_tiny_size():
    from videoquery_torch.tools import cnn_roofline as roof

    cpu = torch.device("cpu")
    assert roof.measure_hbm_read(cpu, gib=1 / 1024, iters=2) > 0
    assert roof.measure_gemm(cpu, torch.float32, m=64, iters=2) > 0
    rows = roof.measure_conv_shape_envelope(cpu, torch.bfloat16, images=1, iters=1)
    assert [r["label"] for r in rows] == [s[0] for s in roof.CONV_SHAPES]
    assert all(r["flop_s"] > 0 and r["m"] == s[1] for r, s in zip(rows, roof.CONV_SHAPES))
