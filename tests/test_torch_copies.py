"""The port's copies of the JAX package's jax-free modules against the
originals: ``pipeline/sampling.py``, ``pipeline/decode.py`` (the functions
the port calls) and ``testing/{fake_api,serve_fake_api}.py``.

The port imports nothing of the JAX package, so it carries these copies; a
copy that drifts from its original is caught here. Equality is exact: the
same numpy arithmetic, the same decoded bytes, the same API state after the
same fixture round.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from conftest import REFERENCE_FIXTURES
from videoquery.pipeline import decode as jdecode
from videoquery.pipeline import sampling as jsampling
from videoquery.testing import fake_api as jfake
from videoquery_torch.core.config import HyperParams
from videoquery_torch.pipeline import decode, sampling
from videoquery_torch.service.compute_matches import compute_matches
from videoquery_torch.service.loader import DBLoader
from videoquery_torch.service.repository import APIRepository
from videoquery_torch.testing import fake_api, serve_fake_api

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)


FIXTURE = os.path.join(REFERENCE_FIXTURES, "stock-video-clips_features")


@pytest.mark.parametrize("num_ticks,depth", [(25, 5), (25, 1), (3, 5), (5, 2)])
def test_sampling_copy_equals_original(num_ticks, depth):
    for n in range(1, 260):
        np.testing.assert_array_equal(sampling.frame_ticks(n, num_ticks, depth),
                                      jsampling.frame_ticks(n, num_ticks, depth))
        np.testing.assert_array_equal(sampling.flow_stack_index_matrix(n, num_ticks, depth),
                                      jsampling.flow_stack_index_matrix(n, num_ticks, depth))
        got, want = sampling.flow_pair_plan(n, num_ticks, depth), \
            jsampling.flow_pair_plan(n, num_ticks, depth)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for group in (1, 3, 5):
            for a, b in zip(sampling.flow_warm_plan(got[0], group),
                            jsampling.flow_warm_plan(want[0], group)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sampling.flow_stack_indices(n, n + 3, depth),
                                      jsampling.flow_stack_indices(n, n + 3, depth))
        for fps, secs, tail in ((15, 10, 2), (5, 2, 1), (5, 4, 2)):
            assert sampling.clip_ranges(n, fps, secs, tail) == \
                jsampling.clip_ranges(n, fps, secs, tail)


def test_decode_copy_equals_original(tmp_path):
    """synthesize_video writes the same frames, and load_video /
    video_frames decode them to the same bytes, with and without a resize
    and a frame cap."""
    ours, theirs = str(tmp_path / "ours.mp4"), str(tmp_path / "theirs.mp4")
    decode.synthesize_video(ours, n_frames=12, size=(96, 64), seed=3)
    jdecode.synthesize_video(theirs, n_frames=12, size=(96, 64), seed=3)
    for kwargs in ({}, {"new_size": (48, 32)}, {"max_frames": 5}):
        got = decode.load_video(ours, **kwargs)
        np.testing.assert_array_equal(got, jdecode.load_video(theirs, **kwargs))
        np.testing.assert_array_equal(got, jdecode.load_video(ours, **kwargs))
    assert len(list(decode.video_frames(ours, skip_first=False))) == 13
    with pytest.raises(IOError):
        decode.load_video(str(tmp_path / "missing.mp4"))


def fixture_round(fake, report_dir):
    """The fixture CSVs through the port's loader into `fake`'s FakeAPI,
    then new -> revise -> finalize on the port's compute_matches (CPU)."""
    api = fake.FakeAPI()
    n_rows = DBLoader(fake.FakeClient(api)).load_tree(FIXTURE)
    clip_ids = sorted(api.video_clips)
    search = api.add_search_set("all", clip_ids)
    qid = api.add_query("q", next(iter(api.videos)), 1, clip_ids[0], search["id"],
                        max_matches_for_review=10)["id"]

    def poll():
        compute_matches(APIRepository(fake.FakeClient(api), "fake://"), HyperParams(),
                        seed=42, report_dir=report_dir, exact=True, device="cpu")

    def latest():
        r = max((r for r in api.query_results.values() if r["query"] == qid),
                key=lambda r: r["round"])
        return sorted((m for m in api.matches.values() if m["query_result"] == r["id"]),
                      key=lambda m: m["video_clip"])

    poll()
    for m in latest()[:3]:
        api.set_user_match(m["id"], True)
    api.request_revision(qid)
    poll()
    api.set_user_match(latest()[0]["id"], True)
    api.request_finalize(qid)
    poll()
    return n_rows, api, qid


def test_fake_api_copy_drives_the_same_round(tmp_path):
    n_ours, ours, q_ours = fixture_round(fake_api, str(tmp_path / "ours"))
    n_theirs, theirs, q_theirs = fixture_round(jfake, str(tmp_path / "theirs"))
    assert n_ours == n_theirs > 0
    assert ours.queries[q_ours]["process_state"] == 7

    def rows(api, table):   # a query's notes carry wall-clock lease stamps
        return json.dumps({k: {f: v for f, v in row.items() if f != "notes"}
                           for k, row in getattr(api, table).items()},
                          sort_keys=True, default=str)

    for table in ("videos", "video_clips", "features", "queries", "query_results",
                  "matches"):
        assert rows(ours, table) == rows(theirs, table), table
    assert ours.uploaded_reports.keys() == theirs.uploaded_reports.keys()


def test_serve_fake_api_answers_over_http():
    """The port's bridge (python -m videoquery_torch.testing.serve_fake_api)
    serves its FakeAPI on a socket: token, auth check, a list route."""
    srv = serve_fake_api.ThreadingHTTPServer(("127.0.0.1", 0), serve_fake_api.Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}/"
    try:
        req = urllib.request.Request(base + "api-token-auth/", data=b"username=u&password=p",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            token = json.load(r)["token"]
        assert token == serve_fake_api.TOKEN
        req = urllib.request.Request(base + "videos/",
                                     headers={"Authorization": f"Token {token}"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
            json.load(r)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "videos/", timeout=10)
        assert exc.value.code == 401
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert isinstance(serve_fake_api.api, fake_api.FakeAPI)
