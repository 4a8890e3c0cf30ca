"""The port's broker round (videoquery_torch.service) against the JAX
package's, and its own batched == one-job-per-poll contract.

- Fixture CSVs, new -> revise -> finalize, through both packages'
  compute_matches: exact mode gives bitwise-equal snapshots; the f32 path
  gives equal states, match clip sets and rounds, scores within rtol 1e-6.
- The port's batched poll is bit-identical to one job per poll (the world
  of tests/test_batch_serving.py, full-table and resident paths).
- Importing the port's service stack leaves jax out of sys.modules.
"""

import importlib
import math
import os
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

from conftest import REFERENCE_FIXTURES
from test_batch_serving import snapshot
from videoquery.core.config import HyperParams as JaxHyperParams
from videoquery.service.compute_matches import compute_matches as jax_compute
from videoquery.service.repository import APIRepository as JaxRepository
from videoquery.testing.fake_api import FakeAPI, FakeClient
from videoquery_torch.core.config import (STATE_FINALIZED, STATE_IN_PROGRESS,
                                          STATE_PROCESSED, BrokerConfig,
                                          HyperParams)
from videoquery_torch.service.broker import Broker
from videoquery_torch.service.loader import DBLoader
from videoquery_torch.service.repository import APIRepository

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

cm = importlib.import_module("videoquery_torch.service.compute_matches")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REFERENCE_FIXTURES, "stock-video-clips_features")
SEED = 42


def port_poll(api, report_dir, exact=False, max_jobs_per_poll=64):
    cm.compute_matches(APIRepository(FakeClient(api), "fake://"), HyperParams(),
                       seed=SEED, report_dir=report_dir, exact=exact,
                       max_jobs_per_poll=max_jobs_per_poll, device="cpu")


def jax_poll(api, report_dir, exact=False):
    jax_compute(JaxRepository(FakeClient(api), "fake://"), JaxHyperParams(),
                seed=SEED, report_dir=report_dir, exact=exact)


def _latest(api, qid):
    r = max((r for r in api.query_results.values() if r["query"] == qid),
            key=lambda r: r["round"])
    return sorted((m for m in api.matches.values() if m["query_result"] == r["id"]),
                  key=lambda m: m["video_clip"])


def fixture_lifecycle(poll, report_dir):
    """Two queries (static and dynamic target) over the fixture CSVs, loaded
    by the port's DBLoader: new -> revise -> finalize, both queries in each
    poll."""
    api = FakeAPI()
    DBLoader(FakeClient(api)).load_tree(FIXTURE)
    clip_ids = sorted(api.video_clips)
    video_id = next(iter(api.videos))
    search = api.add_search_set("all", clip_ids)
    qids = [api.add_query(f"q{i}", video_id, i + 1, clip_ids[i], search["id"],
                          max_matches_for_review=10,
                          dynamic_target_adjustment=bool(i))["id"]
            for i in range(2)]
    poll(api, report_dir)
    for qid in qids:
        for m, val in zip(_latest(api, qid)[:3], (True, True, False)):
            api.set_user_match(m["id"], val)
        api.request_revision(qid)
    poll(api, report_dir)
    for qid in qids:
        api.set_user_match(_latest(api, qid)[0]["id"], True)
        api.request_finalize(qid)
    poll(api, report_dir)
    for qid in qids:
        assert api.queries[qid]["process_state"] == STATE_FINALIZED, (
            api.queries[qid]["notes"])
        assert qid in api.uploaded_reports
    return api


def test_fixture_lifecycle_exact_bitwise_matches_jax(tmp_path):
    want = fixture_lifecycle(lambda a, d: jax_poll(a, d, exact=True),
                             str(tmp_path / "jax"))
    got = fixture_lifecycle(lambda a, d: port_poll(a, d, exact=True),
                            str(tmp_path / "port"))
    assert snapshot(got) == snapshot(want)


def test_fixture_lifecycle_f32_matches_jax(tmp_path):
    want = fixture_lifecycle(jax_poll, str(tmp_path / "jax"))
    got = fixture_lifecycle(port_poll, str(tmp_path / "port"))
    sw, sg = snapshot(want), snapshot(got)
    assert sg.keys() == sw.keys()
    for name in sw:
        (state_w, notes_w, rounds_w, _), (state_g, notes_g, rounds_g, _) = sw[name], sg[name]
        assert state_g == state_w and notes_g == notes_w
        assert [r[0] for r in rounds_g] == [r[0] for r in rounds_w] == [1, 2, 3]
        for rw, rg in zip(rounds_w, rounds_g):
            assert math.isclose(rg[1], rw[1], rel_tol=1e-6)  # threshold
            mw, mg = rw[4], rg[4]
            assert [m[0] for m in mg] == [m[0] for m in mw] and mw
            assert [m[2:] for m in mg] == [m[2:] for m in mw]
            np.testing.assert_allclose([m[1] for m in mg], [m[1] for m in mw],
                                       rtol=1e-6)


# -- batched == one job per poll (tests/test_batch_serving.py's world) ---------

STREAMS = ("rgb", "warped_optical_flow")
N_CLIPS, DIM = 160, 24


def _cone(rng, u, theta):
    w = rng.standard_normal(u.shape[0])
    w -= w @ u * u
    w /= np.linalg.norm(w)
    return np.cos(theta) * u + np.sin(theta) * w


def _n_pending(api):
    return sum(q["process_state"] in (1, 2, 6) for q in api.queries.values())


def drain(api, tmp_path, max_jobs_per_poll=64):
    # a report directory per drain: two worlds name their reports alike
    report_dir = tempfile.mkdtemp(prefix="reports_", dir=tmp_path)
    polls = 0
    while _n_pending(api) and polls < 50:
        port_poll(api, report_dir, max_jobs_per_poll=max_jobs_per_poll)
        polls += 1
    assert _n_pending(api) == 0
    return polls


def build_world(tmp_path, n_queries=9, n_new_later=2):
    """One shared search set; n_queries queries with round 1 processed, then
    a mixed pending batch of revises, finalizes and new queries."""
    rng = np.random.default_rng(7)
    api = FakeAPI()
    video = api.add_video("vid", "")
    u = rng.standard_normal(DIM)
    u /= np.linalg.norm(u)
    clip_ids = []
    for i, theta in enumerate(np.linspace(0.0, 1.3, N_CLIPS)):
        c = api.add_clip(video["id"], i + 1)
        clip_ids.append(c["id"])
        for s in STREAMS:
            for split in (1, 2, 3):
                api.add_feature(c["id"], s, split,
                                _cone(rng, u, theta + 0.03 * rng.standard_normal()))
    search = api.add_search_set("shared", clip_ids)
    queries = [api.add_query(f"q{api.next_id()}", video["id"], qi + 1, clip_ids[qi],
                             search["id"], max_matches_for_review=6,
                             dynamic_target_adjustment=qi % 3 == 1)
               for qi in range(n_queries)]
    drain(api, tmp_path)
    for qi, q in enumerate(queries):
        assert api.queries[q["id"]]["process_state"] == STATE_PROCESSED
        for m, val in zip(_latest(api, q["id"])[:3], (True, True, False)):
            api.set_user_match(m["id"], val)
        (api.request_revision if qi < 5 else api.request_finalize)(q["id"])
    for qi in range(n_new_later):
        api.add_query(f"q{api.next_id()}", video["id"], 40 + qi, clip_ids[40 + qi],
                      search["id"], max_matches_for_review=6)
    return api


def test_port_batched_poll_bit_identical_to_sequential(tmp_path):
    seq, bat = build_world(tmp_path), build_world(tmp_path)
    assert snapshot(seq) == snapshot(bat)
    assert drain(seq, tmp_path, max_jobs_per_poll=1) == 11
    assert drain(bat, tmp_path) == 1
    assert snapshot(seq) == snapshot(bat)
    states = [q["process_state"] for q in bat.queries.values()]
    assert states.count(STATE_FINALIZED) == 4 and states.count(STATE_PROCESSED) == 7


def test_port_resident_batched_poll_bit_identical(tmp_path, monkeypatch):
    """The same contract through the big-corpus ResidentTable path."""
    monkeypatch.setattr(cm, "SearchConfig",
                        lambda: types.SimpleNamespace(big_round_threshold=100))
    seq, bat = build_world(tmp_path), build_world(tmp_path)
    drain(seq, tmp_path, max_jobs_per_poll=1)
    drain(bat, tmp_path)
    assert snapshot(seq) == snapshot(bat)


def test_port_resident_group_survives_a_job_that_cannot_be_prepared(tmp_path, monkeypatch):
    """One revise job of a resident poll group whose reviewed match names a
    clip outside the search set: its round prep raises, it alone stays in
    progress (for lease recovery), and every other job of its group ends
    as in a poll without it."""
    monkeypatch.setattr(cm, "SearchConfig",
                        lambda: types.SimpleNamespace(big_round_threshold=100))
    clean, bad = build_world(tmp_path), build_world(tmp_path)
    bad_q = min(q["id"] for q in bad.queries.values() if q["process_state"] == 2)
    _latest(bad, bad_q)[-1]["video_clip"] = 10 ** 9
    prep_sizes = []
    prep = cm._prepare_group_rounds
    monkeypatch.setattr(cm, "_prepare_group_rounds",
                        lambda gjobs, hp: (prep_sizes.append(len(gjobs)), prep(gjobs, hp)))
    port_poll(bad, tempfile.mkdtemp(prefix="reports_", dir=tmp_path))
    assert prep_sizes == [11] + [1] * 11  # the group, then each job alone
    assert bad.queries[bad_q]["process_state"] == STATE_IN_PROGRESS
    drain(clean, tmp_path)
    want, got = snapshot(clean), snapshot(bad)
    name = bad.queries[bad_q]["name"]
    assert {k: v for k, v in got.items() if k != name} == {
        k: v for k, v in want.items() if k != name}
    states = [q["process_state"] for q in bad.queries.values()]
    assert states.count(STATE_FINALIZED) == 4 and states.count(STATE_PROCESSED) == 6


def test_process_job_resident_round_equals_the_full_download(tmp_path, monkeypatch):
    """process_job over a resident table prepares its round as a poll group
    of one, and ends every round of the fixture lifecycle as the
    full-download path does, bit for bit."""
    def job_poll(api, report_dir):
        repo = APIRepository(FakeClient(api), "fake://")
        for job in cm.drain_pending_jobs(repo, repo.client, seed=SEED,
                                         report_dir=report_dir):
            cm.process_job(job.ticket, job.update_type, job.update_object,
                           HyperParams(), rng=job.rng, device="cpu")

    full = snapshot(fixture_lifecycle(job_poll, str(tmp_path / "full")))
    prep_sizes = []
    prep = cm._prepare_group_rounds
    monkeypatch.setattr(cm, "_prepare_group_rounds",
                        lambda gjobs, hp: (prep_sizes.append(len(gjobs)), prep(gjobs, hp)))
    monkeypatch.setattr(cm, "SearchConfig",
                        lambda: types.SimpleNamespace(big_round_threshold=1))
    resident = snapshot(fixture_lifecycle(job_poll, str(tmp_path / "resident")))
    assert prep_sizes == [1] * 6  # two queries, three rounds each
    assert resident == full


def test_broker_run_once_processes_a_query(tmp_path):
    api = FakeAPI()
    DBLoader(FakeClient(api)).load_tree(FIXTURE)
    clip_ids = sorted(api.video_clips)
    search = api.add_search_set("all", clip_ids)
    q = api.add_query("q", next(iter(api.videos)), 1, clip_ids[0], search["id"])
    broker = Broker(BrokerConfig(report_dir=str(tmp_path)), client=FakeClient(api),
                    exact=False, device="cpu")
    broker.run_once()
    assert api.queries[q["id"]]["process_state"] == STATE_PROCESSED
    assert _latest(api, q["id"])


def test_compute_matches_never_picks_the_cpu_itself(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    monkeypatch.delenv("VIDEOQUERY_DEVICE", raising=False)
    with pytest.raises(RuntimeError):
        cm.compute_matches(APIRepository(FakeClient(FakeAPI()), "fake://"),
                           HyperParams())


def test_port_service_imports_without_jax():
    code = ("import sys\n"
            "import videoquery_torch.service.broker, videoquery_torch.service.loader\n"
            "import videoquery_torch.search.engine, videoquery_torch.kernels.query\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or (m.startswith('videoquery.') and not m.startswith('videoquery.testing'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr
