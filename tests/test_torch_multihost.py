"""The port's 2-process world (videoquery_torch.testing.multihost_worker).

Two spawned worker processes join one Gloo world through a ``file://``
store under the test's temporary directory and run the sharded search and
two DDP train steps whose collectives cross the process boundary. Their
results must agree with each other exactly, equal the same world run as
one rank in this process (rtol 1e-5), and give the top-k ids of the JAX
package's world on conftest's 8 virtual devices.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from videoquery_torch.core.meshes import initialize_multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    """Spawn the 2 workers once; several tests read their outputs."""
    tmp = tmp_path_factory.mktemp("mh")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs, outs = [], []
    for pid in range(2):
        out = str(tmp / f"r{pid}.json")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "videoquery_torch.testing.multihost_worker",
             "--init_method", f"file://{tmp / 'store'}", "--nprocs", "2",
             "--pid", str(pid), "--out", out, "--device", "cpu"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("multihost worker timed out (rendezvous hang?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{lg[-3000:]}"
    return [json.load(open(o)) for o in outs]


def test_two_process_world_comes_up(worker_results):
    assert [r["process_id"] for r in worker_results] == [0, 1]
    for r in worker_results:
        assert r["world_size"] == 2


def test_workers_agree(worker_results):
    r0, r1 = worker_results
    assert r0["topk_ids"] == r1["topk_ids"]
    assert r0["topk_vals"] == r1["topk_vals"]
    assert [r0["loss"], r0["accuracy"], r0["loss2"]] == [r1["loss"], r1["accuracy"], r1["loss2"]]
    assert np.isfinite([r0["loss"], r0["loss2"]]).all()


def test_matches_one_rank_in_process(worker_results, tmp_path):
    """The same world as one rank: the process boundary and the world size
    do not change the math (the dropout mask is drawn for the global
    batch)."""
    from videoquery_torch.testing.multihost_worker import run_world

    initialize_multihost(f"file://{tmp_path / 'store'}", 1, 0, "cpu")
    try:
        ref = run_world("cpu")
    finally:
        dist.destroy_process_group()
    for r in worker_results:
        assert r["topk_ids"] == ref["topk_ids"]
        np.testing.assert_allclose(r["topk_vals"], ref["topk_vals"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["loss2"], ref["loss2"], rtol=1e-5)
        assert r["accuracy"] == ref["accuracy"]


def test_topk_ids_match_the_jax_world(worker_results):
    """The numpy draws are the JAX world's, so is the index: the JAX
    ShardedSearch on 8 virtual devices ranks the same clips."""
    import jax

    from videoquery.testing.multihost_worker import run_world as jax_run_world

    assert jax.device_count() == 8
    want = jax_run_world(jax)
    for r in worker_results:
        assert r["topk_ids"] == want["topk_ids"]
        np.testing.assert_allclose(r["topk_vals"], want["topk_vals"], rtol=1e-5, atol=1e-6)
