"""The port's sharded extractor (``Extractor(mesh=...)``,
``ensemble_embed``, ``StreamEnsemble.shard``, ``default_flow_impl``)
against the JAX package and against the one-rank extractor.

- In a 1-rank Gloo world (a ``file://`` store under the test's temporary
  directory) against the JAX ``Extractor(mesh=make_mesh(model_parallel=2))``
  on conftest's 8 virtual devices, at tests/test_distributed.py's geometry
  (splits (1, 2), flow_impl "xla", unwarped): clip numbers equal, rgb and
  flow within rtol 1e-4 / atol 1e-5 (tests/test_torch_extract.py's).
- Two spawned Gloo processes as a (data 2, model 1) and a (data 1, model 2)
  mesh (``testing/multihost_worker.py --world extract``: warped flow on the
  pair path, the rescue on, a 4-clip batch and a 1-clip tail) against the
  one-rank extractor in this process: clip numbers equal, signatures within
  rtol 1e-5 / atol 1e-6 (a CPU conv may round differently at another batch
  size); whether they are bitwise is printed (they were, when written).
- The tail: the JAX extractor raises on a 1-clip batch over a data axis of
  4; the port pads the shard and drops the padded rows (ROADMAP §3).
- A model axis that does not divide the splits is refused, as the JAX
  shard_map refuses it.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from videoquery.core.config import ExtractionConfig as JaxExtractionConfig
from videoquery.core.meshes import make_mesh as jax_make_mesh
from videoquery.kernels.tvl1 import TVL1Params as JaxTVL1Params
from videoquery.nn.tsn import StreamEnsemble as JaxStreamEnsemble
from videoquery.nn.tsn import TwoStreamTSN as JaxTSN
from videoquery.pipeline import extract as je
from videoquery_torch.core.config import ExtractionConfig
from videoquery_torch.core.meshes import initialize_multihost, make_mesh
from videoquery_torch.kernels.tvl1 import TVL1Params
from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN
from videoquery_torch.pipeline import extract as te
from videoquery_torch.testing import multihost_worker as mw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

# tests/test_distributed.py::test_extractor_with_mesh's geometry
DIST_CFG = dict(fps=5, clip_seconds=2, num_ticks=4, frame_resize=(120, 96), crop_size=64,
                batch_clips=4, min_tail_seconds=1)
DIST_TVL1 = dict(n_scales=2, n_warps=1, n_iters=4)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A Gloo world of one rank, for this module's in-process tests."""
    store = tmp_path_factory.mktemp("dist") / "store"
    initialize_multihost(f"file://{store}", 1, 0, "cpu")
    try:
        yield make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def port_tsn(jtsn):
    """The port's ensembles with a JAX TwoStreamTSN's weights."""
    def unstack(stream):
        return {s: jax.tree.map(lambda a: np.asarray(a[i]), stream.stacked_params)
                for i, s in enumerate(stream.splits)}
    return TwoStreamTSN.from_jax_params(unstack(jtsn.rgb), unstack(jtsn.flow), device="cpu")


def test_sharded_extractor_matches_jax(mesh1, rng):
    jtsn = JaxTSN(JaxStreamEnsemble.random(jax.random.PRNGKey(0), 3, splits=(1, 2)),
                  JaxStreamEnsemble.random(jax.random.PRNGKey(1), 10, splits=(1, 2)))
    frames = rng.integers(0, 255, (40, 64, 80, 3)).astype(np.uint8)
    jex = je.Extractor(jtsn, JaxExtractionConfig(**DIST_CFG), warped=False,
                       tvl1=JaxTVL1Params(**DIST_TVL1), flow_impl="xla",
                       mesh=jax_make_mesh(model_parallel=2))
    want = je.gather_signatures(list(jex.extract_frames(frames)))
    pex = te.Extractor(port_tsn(jtsn), ExtractionConfig(**DIST_CFG), warped=False,
                       tvl1=TVL1Params(**DIST_TVL1), flow_impl="xla", device="cpu",
                       mesh=mesh1)
    got = te.gather_signatures(list(pex.extract_frames(frames)))
    assert [s.clip_numbers for s in got] == [s.clip_numbers for s in want] == [[1, 2, 3, 4]]
    for g, w in zip(got, want):
        assert g.rgb.shape == (2, 4, 1024) and g.splits == w.splits == (1, 2)
        np.testing.assert_allclose(g.rgb, np.asarray(w.rgb), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g.flow, np.asarray(w.flow), rtol=1e-4, atol=1e-5)


def test_jax_extractor_refuses_a_tail_shorter_than_the_data_axis():
    """The reference defect the port decides otherwise (ROADMAP §3): a
    1-clip tail batch cannot be placed on a data axis of 4."""
    jtsn = JaxTSN(JaxStreamEnsemble.random(jax.random.PRNGKey(0), 3, splits=(1, 2)),
                  JaxStreamEnsemble.random(jax.random.PRNGKey(1), 10, splits=(1, 2)))
    jex = je.Extractor(jtsn, JaxExtractionConfig(**DIST_CFG), warped=False,
                       tvl1=JaxTVL1Params(**DIST_TVL1), flow_impl="xla",
                       mesh=jax_make_mesh(model_parallel=2))
    frames = np.zeros((6, 64, 80, 3), np.uint8)          # one 6-frame tail clip
    with pytest.raises(ValueError, match="divisible by 4"):
        list(jex.extract_frames(frames))


@pytest.fixture(scope="module")
def one_rank():
    """The one-rank extractor on the extraction world's video, and how many
    pairs each rescue call saw triggered."""
    triggered = []
    rescue = te._rescue_fast_motion

    def spy(i0, i1, u, v, warped, tvl1, max_disp=6, shard=None, wait=True):
        n, h, w = u.shape
        mag = torch.maximum(u.abs(), v.abs())[:, :h // 4 * 4, :w // 4 * 4]
        peak = mag.reshape(n, h // 4, 4, w // 4, 4).mean(dim=(2, 4)).reshape(n, -1).amax(1)
        triggered.append(int((peak >= tvl1.rescue_trigger * max_disp).sum()))
        return rescue(i0, i1, u, v, warped, tvl1, max_disp, shard, wait)

    tsn = TwoStreamTSN(StreamEnsemble.random(0, 3, (1, 2), "cpu"),
                       StreamEnsemble.random(1, 10, (1, 2), "cpu"))
    ex = te.Extractor(tsn, ExtractionConfig(**mw.EXTRACT_WORLD), warped=True,
                      tvl1=mw.extract_world_tvl1(), device="cpu")
    te._rescue_fast_motion = spy
    try:
        sigs = te.gather_signatures(list(ex.extract_frames(mw.extract_world_video())))
    finally:
        te._rescue_fast_motion = rescue
    return sigs, triggered


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 2 workers of the extraction world once."""
    tmp = tmp_path_factory.mktemp("mhx")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs, outs = [], []
    for pid in range(2):
        out = str(tmp / f"r{pid}.npz")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "videoquery_torch.testing.multihost_worker",
             "--init_method", f"file://{tmp / 'store'}", "--nprocs", "2",
             "--pid", str(pid), "--out", out, "--device", "cpu", "--world", "extract"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("extraction worker timed out (rendezvous hang?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{lg[-3000:]}"
    return [dict(np.load(o)) for o in outs]


def test_the_world_runs_the_rescue(one_rank):
    """The extraction world's video makes the rescue re-solve pairs, so the
    worlds below hold its batch-wide choice too."""
    _sigs, triggered = one_rank
    assert triggered and triggered[0] > 0, triggered


@pytest.mark.parametrize("pid", [0, 1])
@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_two_process_worlds_match_one_rank(world, one_rank, shape, pid):
    sigs, _ = one_rank
    got = world[pid]
    assert [s.clip_numbers for s in sigs] == [[1, 2, 3, 4], [5]]   # a batch and the tail
    bitwise = True
    for i, s in enumerate(sigs):
        assert list(got[f"{shape}/{i}/clips"]) == s.clip_numbers
        for stream in ("rgb", "flow"):
            a, b = got[f"{shape}/{i}/{stream}"], getattr(s, stream)
            assert a.shape == b.shape == (2, len(s.clip_numbers), 1024)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            bitwise &= bool(np.array_equal(a, b))
    print(json.dumps({"world": shape, "rank": pid, "bitwise": bitwise}))


def test_only_the_first_rank_writes_csvs(world):
    for shape in ("2x1", "1x2"):
        assert int(world[0][f"{shape}/csvs"]) == 4       # 2 splits x 2 streams
        assert int(world[1][f"{shape}/csvs"]) == 0


def test_a_model_axis_must_divide_the_splits(world, mesh1):
    """K = 3 splits over a model axis of 2: the world's Extractor raised
    ValueError (``run_extract_world``), and so does the shard itself."""
    for r in world:
        assert int(r["refused_k3_over_model_2"]) == 1
    stream = StreamEnsemble.random(0, 3, (1, 2, 3), "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        stream.shard(0, 2)


def test_stream_shard_keeps_the_modules():
    """A shard is a contiguous run of splits of the same nets (their bf16
    and T1 caches stay with them), in split order."""
    stream = StreamEnsemble.random(0, 3, (1, 2, 3, 4), "cpu")
    parts = [stream.shard(r, 2) for r in range(2)]
    assert [p.splits for p in parts] == [(1, 2), (3, 4)]
    assert [n for p in parts for n in p.nets] == stream.nets
    assert all(a is b for a, b in zip(parts[0].nets + parts[1].nets, stream.nets))
    assert stream.shard(0, 1).nets == stream.nets
    with pytest.raises(ValueError):
        stream.shard(2, 2)


def test_a_world_of_one_takes_the_sharded_path(mesh1, one_rank):
    """On a mesh of one rank the Extractor runs the sharded code, not a
    shortcut beside it: the data shard, the rescue's all-gather of the
    peaks, the model shard and both signature all-gathers, each over a
    group of one. Its signatures equal the one-rank extractor's bit for
    bit."""
    import sys

    calls = []
    gather = te.all_gather_cat

    def spy(x, group, dim=0):
        calls.append((sys._getframe(1).f_code.co_name, dist.get_world_size(group)))
        return gather(x, group, dim)

    tsn = TwoStreamTSN(StreamEnsemble.random(0, 3, (1, 2), "cpu"),
                       StreamEnsemble.random(1, 10, (1, 2), "cpu"))
    ex = te.Extractor(tsn, ExtractionConfig(**mw.EXTRACT_WORLD), warped=True,
                      tvl1=mw.extract_world_tvl1(), device="cpu", mesh=mesh1)
    te.all_gather_cat = spy
    try:
        got = te.gather_signatures(list(ex.extract_frames(mw.extract_world_video())))
    finally:
        te.all_gather_cat = gather
    sites = {name for name, _ in calls}
    assert sites == {"_dispatch_payload", "ensemble_embed", "_rescue_fast_motion"}, calls
    assert all(size == 1 for _, size in calls), calls
    want, _ = one_rank
    assert [s.clip_numbers for s in got] == [s.clip_numbers for s in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.rgb.view(np.uint32), w.rgb.view(np.uint32))
        assert np.array_equal(g.flow.view(np.uint32), w.flow.view(np.uint32))


def test_ensemble_embed_on_a_mesh_of_one(mesh1):
    stream = StreamEnsemble.random(0, 3, (1, 2), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 64, 64, 3)).astype(np.float32) * 50)
    want = stream.embed(x)
    assert torch.equal(te.ensemble_embed(stream, x), want)
    assert torch.equal(te.ensemble_embed(stream, x, mesh1), want)


def test_default_flow_impl_is_the_kernels_on_every_device():
    assert te.default_flow_impl() == "pallas"
    assert te.Extractor(TwoStreamTSN.random(0, (1,), "cpu"), device="cpu").flow_impl == \
        te.default_flow_impl()
