"""The port's multi-process decode (videoquery_torch.pipeline.mpstream):
ports of tests/test_mpstream.py's behaviour tests, on the CPU.

Worker processes decode distinct videos and stream payloads to the
dispatching process; the signatures equal the one-process streaming path's
bit for bit (the same payload builder, the same device step). A pool whose
configuration is not the extractor's is refused. The tests share one
module-scoped 2-worker pool for the extraction and one for the throttled
stub producers (videoquery_torch.testing.mp_stubs); they assert behaviour,
never a speed ratio. The stub pool's dead-worker test runs last: a dead
worker is not replaced.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from videoquery_torch.core.config import ExtractionConfig
from videoquery_torch.kernels.tvl1 import TVL1Params
from videoquery_torch.nn.tsn import TwoStreamTSN
from videoquery_torch.pipeline import decode
from videoquery_torch.pipeline.extract import Extractor, build_payload, plan_groups
from videoquery_torch.pipeline.mpstream import (WorkerPool, extract_videos_mp,
                                                stream_dispatch)
from videoquery_torch.pipeline.payload import stream_payloads

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = "videoquery_torch.testing.mp_stubs:throttled_payloads"
# the small geometry of tests/test_torch_extract.py (96x64 frames, 64 px
# crops), 20-frame clips and every compact upload
CFG = dict(fps=5, clip_seconds=4, num_ticks=5, frame_resize=(96, 64), crop_size=64,
           batch_clips=2, host_gray=True, host_crop=True, host_yuv420=True)
TVL1 = TVL1Params(n_scales=2, n_warps=1, n_iters=4)


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    """Two videos, decoded to 96x64: 80 frames (4 full clips) and 50 (2 full
    clips and a 10-frame tail, at fps 5, 4 s clips, a 2 s least tail)."""
    tmp = tmp_path_factory.mktemp("mpstream")
    paths = []
    for i, n in enumerate((80, 50)):
        p = str(tmp / f"v{i}.mp4")
        decode.synthesize_video(p, n_frames=n, size=(176, 128))
        paths.append(p)
    tsn = TwoStreamTSN.random(0, splits=(1,), device="cpu")
    return paths, Extractor(tsn, ExtractionConfig(**CFG), warped=False, tvl1=TVL1,
                            device="cpu")


@pytest.fixture(scope="module")
def pool(small_world):
    """One 2-worker decode pool for the extractor's configuration."""
    _paths, ex = small_world
    with WorkerPool(2, ex.cfg, ex.flow_res_div, ex._decode_size()) as p:
        yield p


@pytest.fixture(scope="module")
def stub_pool():
    with WorkerPool(2, ExtractionConfig(), 2, None, payload_spec=STUB,
                    queue_window=64) as p:
        yield p


def _flat(sigs):
    return {n: (s.rgb[:, i], s.flow[:, i]) for s in sigs for i, n in enumerate(s.clip_numbers)}


def test_mp_matches_single_process_streaming(small_world, pool):
    paths, ex = small_world
    by_path = extract_videos_mp(ex, paths, pool=pool)
    for p in paths:
        got, want = _flat(by_path[p]), _flat(ex.extract_video_stream(p))
        assert sorted(got) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(got[n][0], want[n][0])
            np.testing.assert_array_equal(got[n][1], want[n][1])


def test_mp_single_worker_and_order(small_world):
    """A one-shot fleet of one worker (extract_videos spawns and stops it):
    each video's clips in order; the 50-frame video has 2 full clips and a
    tail."""
    paths, ex = small_world
    by_path = ex.extract_videos(paths, workers=1)
    for sigs in by_path.values():
        nums = [n for s in sigs for n in s.clip_numbers]
        assert nums == sorted(nums)
    assert sum(len(s.clip_numbers) for s in by_path[paths[1]]) == 3


def test_mp_decode_failure_raises_after_others_finish(small_world, pool, tmp_path):
    paths, ex = small_world
    bad = str(tmp_path / "bad.mp4")
    with open(bad, "wb") as f:
        f.write(b"not a video")
    with pytest.raises(RuntimeError, match="1/3 videos failed"):
        extract_videos_mp(ex, list(paths) + [bad], pool=pool)
    assert all(p.is_alive() for p in pool.procs)   # an error is not a death


def test_mp_refuses_a_pool_of_another_configuration(small_world, pool):
    """A pool started for another config or decode size raises ValueError
    naming both keys, before any video is queued."""
    paths, ex = small_world
    other = Extractor(ex.tsn, ExtractionConfig(**{**CFG, "host_yuv420": False}),
                      warped=False, tvl1=TVL1, device="cpu")
    calls = pool._call_id
    with pytest.raises(ValueError, match="host_yuv420=True") as err:
        extract_videos_mp(other, paths, pool=pool)
    assert "host_yuv420=False" in str(err.value)
    with pytest.raises(ValueError, match=r"\(48, 32\)"):
        extract_videos_mp(ex, paths, pool=pool, new_size=(48, 32))
    assert pool._call_id == calls


def test_stream_payloads_constant_window(small_world):
    """Payloads streamed from the window equal those built from the whole
    decoded video."""
    paths, ex = small_world
    frames = decode.load_video(paths[0], new_size=ex._decode_size())
    pls = list(stream_payloads(paths[0], ex.cfg, ex.flow_res_div, ex._decode_size()))
    nums = [n for pl in pls for n in pl.nums]
    assert sorted(nums) == list(range(1, len(nums) + 1))
    by_num = {n: pl for pl in pls for n in pl.nums}
    for group, gnums in plan_groups(len(frames), ex.cfg):
        ref = build_payload(frames, None, group, gnums, ex.cfg, ex.flow_res_div)
        pl = by_num[gnums[0]]
        np.testing.assert_array_equal(pl.gray, ref.gray)
        np.testing.assert_array_equal(pl.clip_rgb, ref.clip_rgb)


def _run(pool, paths):
    return stream_dispatch(pool, paths, dispatch=lambda p: p)


def test_persistent_pool_reuses_workers_across_calls(stub_pool):
    """Two calls on one pool: every payload comes from the pool's own
    processes (which of them serves a call depends on the load)."""
    fleet = {p.pid for p in stub_pool.procs}
    r1, e1 = _run(stub_pool, ["throttle:2:0.01"] * 3)
    r2, e2 = _run(stub_pool, ["throttle:3:0.01"] * 2)
    assert not e1 and not e2
    assert all(len(v) == 2 for v in r1.values())
    assert len(r2) == 2 and all(len(v) == 3 for v in r2.values())
    pids = {p["pid"] for r in (r1, r2) for v in r.values() for p in v}
    assert pids <= fleet == {p.pid for p in stub_pool.procs}   # no respawn


def test_worker_error_reported_per_video(stub_pool):
    results, errors = _run(stub_pool, ["throttle:4:0.01:fail", "throttle:4:0.01"])
    assert len(errors) == 1 and "synthetic decode failure" in errors[0]
    assert len(results[1]) == 4


def test_dead_worker_fails_video_instead_of_hanging(stub_pool):
    """A worker that dies without posting an error (the segfault model)
    fails its video once liveness polling finds it; the healthy worker's
    video completes; the dead worker is not replaced."""
    results, errors = _run(stub_pool, ["throttle:3:0.01:die", "throttle:40:0.01"])
    assert len(errors) == 1 and "died without reporting" in errors[0]
    assert len(results[1]) == 40
    assert sum(p.is_alive() for p in stub_pool.procs) == 1


def test_worker_side_modules_load_neither_torch_nor_jax():
    """What a decode worker imports (the payload module and mpstream) and
    the caffemodel converter load neither torch nor jax."""
    code = ("import sys\n"
            "import videoquery_torch.pipeline.payload, videoquery_torch.pipeline.mpstream\n"
            "import videoquery_torch.testing.mp_stubs, videoquery_torch.nn.convert_caffe\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


def test_workers_leave_a_torch_main_alone(monkeypatch):
    """Under ``python -m videoquery_torch.pipeline.extract`` the main module
    imports torch, and spawn would re-run it in each child by its name: the
    pool starts its workers without the parent's main, so a worker has
    loaded neither torch nor jax when it builds payloads."""
    from videoquery_torch.pipeline import extract as te

    monkeypatch.setitem(sys.modules, "__main__", te)   # as `python -m` sets it
    with WorkerPool(1, ExtractionConfig(), 2, None,
                    payload_spec="_mp_probe:loaded_frameworks") as p:
        results, errors = _run(p, ["unused"])
    assert sys.modules["__main__"] is te
    assert not errors and results == {0: [[]]}, (results, errors)


def test_cli_workers_and_prefetch_write_the_streaming_csvs(tmp_path, monkeypatch):
    """The extraction CLI on a directory of two videos, compact uploads on,
    on the CPU: with 2 decode workers and in one process it writes the CSV
    files that Extractor.extract_video_stream's signatures make, byte for
    byte."""
    from videoquery_torch.pipeline import extract as te

    monkeypatch.setenv("VIDEOQUERY_DEVICE", "cpu")
    src = tmp_path / "videos"
    src.mkdir()
    for name, n in (("a", 20), ("b", 12)):     # 2 clips; 1 clip and a dropped tail
        decode.synthesize_video(str(src / f"{name}.mp4"), n_frames=n, size=(160, 120),
                                seed=len(name) + n)
    args = ["--splits", "1", "--num_ticks", "3", "--fps", "5", "--clip_time", "2",
            "--batch_clips", "2", "--host_gray", "--host_crop", "--host_yuv420"]
    te.main([str(src), "--out", str(tmp_path / "mp"), "--workers", "2", *args])
    te.main([str(src), "--out", str(tmp_path / "one"), *args])
    cfg = ExtractionConfig(fps=5, clip_seconds=2, num_ticks=3, batch_clips=2,
                           host_gray=True, host_crop=True, host_yuv420=True)
    ex = Extractor(TwoStreamTSN.random(0, (1,), device="cpu"), cfg, device="cpu")
    for name in ("a", "b"):
        vid = str(src / f"{name}.mp4")
        ex.write_csv_tree(ex.extract_video_stream(vid), str(tmp_path / "stream"), name, vid)
    tree = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "stream")
                  for d, _, fs in os.walk(tmp_path / "stream") for f in fs)
    assert len(tree) == 4
    for rel in tree:
        want = (tmp_path / "stream" / rel).read_bytes()
        assert (tmp_path / "mp" / rel).read_bytes() == want, rel
        assert (tmp_path / "one" / rel).read_bytes() == want, rel
