"""The port's copies of the JAX package's jax-free modules against the
originals: ``pipeline/sampling.py``, ``pipeline/decode.py``,
``testing/{fake_api,serve_fake_api,mp_stubs}.py``, ``nn/prototxt.py``,
``testing/caffe_wire.py`` (the caffemodel writer of tests/test_nn.py), and
the verbatim copies ``index/csvio.py``, ``search/{selection,target}.py``
and ``service/{client,lease,repository}.py`` (their functions, classes and
constants).

The port imports nothing of the JAX package, so it carries these copies; a
copy that drifts from its original is caught here. Equality is exact: the
same numpy arithmetic, the same decoded bytes, the same API state after the
same fixture round.
"""

import ast
import inspect
import json
import os
import textwrap
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from conftest import REFERENCE_FIXTURES
import test_nn
from test_torch_prototxt import TINY
from videoquery.index import csvio as jcsvio
from videoquery.nn import prototxt as jprototxt
from videoquery.pipeline import decode as jdecode
from videoquery.pipeline import sampling as jsampling
from videoquery.search import selection as jselection
from videoquery.search import target as jtarget
from videoquery.service import client as jclient
from videoquery.service import lease as jlease
from videoquery.service import repository as jrepository
from videoquery.testing import fake_api as jfake
from videoquery.testing import mp_stubs as jstubs
from videoquery_torch.core.config import HyperParams
from videoquery_torch.index import csvio
from videoquery_torch.nn import prototxt
from videoquery_torch.pipeline import decode, sampling
from videoquery_torch.search import selection, target
from videoquery_torch.service import client, lease, repository
from videoquery_torch.service.compute_matches import compute_matches
from videoquery_torch.service.loader import DBLoader
from videoquery_torch.service.repository import APIRepository
from videoquery_torch.testing import caffe_wire, fake_api, mp_stubs, serve_fake_api

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


def code_of(obj, ported: bool = False) -> str:
    """A function's or a class's syntax tree without its docstring (a
    class's without its methods' docstrings too). ``ported``: the JAX
    package's imports read as the port's (``videoquery.x`` as
    ``videoquery_torch.x``), as its copies import their siblings."""
    node = ast.parse(textwrap.dedent(inspect.getsource(obj))).body[0]
    if ported:
        for imp in ast.walk(node):
            if isinstance(imp, ast.ImportFrom) and imp.module and \
                    imp.module.split(".")[0] == "videoquery":
                imp.module = "videoquery_torch" + imp.module[len("videoquery"):]
    if ast.get_docstring(node) is not None:
        node.body = node.body[1:]
    if isinstance(node, ast.ClassDef):
        for member in node.body:
            if isinstance(member, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and ast.get_docstring(member) is not None:
                member.body = member.body[1:]
    return ast.dump(node)


def defined_in(module, kind) -> list[str]:
    """The names of `module`'s functions or classes (inspect.isfunction /
    isclass) defined in the module itself."""
    return [n for n, f in vars(module).items()
            if kind(f) and f.__module__ == module.__name__]


VERBATIM = [(csvio, jcsvio), (selection, jselection), (target, jtarget),
            (client, jclient), (lease, jlease), (repository, jrepository)]


@pytest.mark.parametrize("copy,original", [(decode, jdecode), (mp_stubs, jstubs),
                                           (prototxt, jprototxt)] + VERBATIM)
def test_copied_functions_have_the_original_code(copy, original):
    """Every function of decode.py, mp_stubs.py, prototxt.py and the six
    verbatim copies is in the copy with the same code (docstrings aside)."""
    names = defined_in(original, inspect.isfunction)
    assert names or original is jrepository   # repository.py is one class
    for name in names:
        assert code_of(getattr(copy, name)) == \
            code_of(getattr(original, name), ported=True), name


@pytest.mark.parametrize("copy,original",
                         [c for c in VERBATIM if defined_in(c[1], inspect.isclass)])
def test_copied_classes_have_the_original_code(copy, original):
    """Every class of the verbatim copies (FeatureCSV, TargetEstimator,
    Transport, HTTPTransport, ActionClient, LeaseRecovery, APIRepository)
    is in the copy with the same body: its fields and every method's code
    (docstrings aside)."""
    names = defined_in(original, inspect.isclass)
    assert names
    for name in names:
        assert code_of(getattr(copy, name)) == \
            code_of(getattr(original, name), ported=True), name


@pytest.mark.parametrize("copy,original", VERBATIM)
def test_copied_constants_have_the_original_values(copy, original):
    """The module-level constants of the verbatim copies: the same values
    (a pattern by its source)."""
    names = [n for n, v in vars(original).items()
             if n.isupper() or (n.startswith("_") and n.lstrip("_").isupper())]
    for name in names:
        a, b = getattr(copy, name), getattr(original, name)
        if hasattr(b, "pattern"):
            a, b = a.pattern, b.pattern
        assert a == b, name


def test_decode_helpers_copy_equals_original(tmp_path, monkeypatch):
    """The grown decode copy against the original on the same inputs:
    gray, its box prefactor, the frame count and fps probes, the seek-based
    range decode and the chunked parallel decode (also when a chunk seeks
    one frame late, where both fall back to the sequential reader)."""
    path = str(tmp_path / "v.mp4")
    decode.synthesize_video(path, n_frames=130, size=(64, 48))
    frames = decode.load_video(path)
    np.testing.assert_array_equal(decode.to_grayscale(frames[:5]),
                                  jdecode.to_grayscale(frames[:5]))
    for args in ((256, 340, 128, 128), (255, 339, 100, 120), (512, 512, 64, 64), (48, 64, 48, 64)):
        assert decode._box_factor(*args) == jdecode._box_factor(*args)
    assert decode.probe_frame_count(path) == jdecode.probe_frame_count(path) == 131
    assert decode.video_fps(path) == jdecode.video_fps(path) == 15.0
    for start, count, size in ((0, 5, None), (40, 41, None), (100, 50, (32, 24))):
        got = decode._decode_range(path, start, count, size)
        want = jdecode._decode_range(path, start, count, size)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    par = decode.load_video_parallel(path, workers=4, chunk=40)
    np.testing.assert_array_equal(par, jdecode.load_video_parallel(path, workers=4, chunk=40))
    np.testing.assert_array_equal(par, frames)
    real = decode._decode_range

    def shifted(p, start, count, new_size):
        out = real(p, start, count, new_size)
        if start == 40:   # the second chunk "seeks" one frame late
            return out[1:] + real(p, start + count, 1, new_size)
        return out

    monkeypatch.setattr(decode, "_decode_range", shifted)
    np.testing.assert_array_equal(decode.load_video_parallel(path, workers=4, chunk=40), frames)


def test_mp_stubs_copy_yields_the_same_payloads():
    for path in ("throttle:3:0", "throttle:4:0:fail"):
        got, want = [], []
        for out, stubs in ((got, mp_stubs), (want, jstubs)):
            try:
                out.extend(stubs.throttled_payloads(path, None, 2, None))
            except RuntimeError as exc:
                out.append(str(exc))
        assert got == want and len(got) == 3   # 3 payloads, or 2 and the failure


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


def test_prototxt_copy_parses_as_the_original(tmp_path):
    """The same message tree from the same text and file, the token
    pattern unchanged, the same refusals."""
    assert prototxt._TOKEN.pattern == jprototxt._TOKEN.pattern
    assert prototxt.parse(TINY) == jprototxt.parse(TINY)
    path = tmp_path / "tiny.prototxt"
    path.write_text(TINY)
    assert prototxt.load_net(str(path)) == jprototxt.load_net(str(path))
    assert prototxt.as_list(None) == jprototxt.as_list(None) == []
    for bad in ("layer { ! }", "12"):
        with pytest.raises(ValueError):
            jprototxt.parse(bad)
        with pytest.raises(ValueError):
            prototxt.parse(bad)


WIRE = ("_varint", "_len_field", "_blob", "_layer", "_scalar_field", "_blob_v1", "_layer_v1")


@pytest.mark.parametrize("name", WIRE)
def test_caffe_wire_copy_has_the_tests_code(name):
    assert code_of(getattr(caffe_wire, name)) == code_of(getattr(test_nn, name))


def test_caffe_wire_copy_writes_the_same_bytes(rng):
    w = rng.normal(size=(8, 4, 3, 3)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    fc = rng.normal(size=(101, 1024)).astype(np.float32)
    for n in (0, 1, 127, 128, 300, 2 ** 31):
        assert caffe_wire._varint(n) == test_nn._varint(n)
    assert caffe_wire._layer("conv1/7x7_s2", "Convolution", [w, b]) == \
        test_nn._layer("conv1/7x7_s2", "Convolution", [w, b])
    assert caffe_wire._layer_v1("fc-action", 14, [fc, np.zeros(101, np.float32)]) == \
        test_nn._layer_v1("fc-action", 14, [fc, np.zeros(101, np.float32)])
    assert caffe_wire._len_field(1, b"net") == test_nn._len_field(1, b"net")
