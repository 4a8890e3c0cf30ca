"""In-process fake of the Video Query REST API.

A copy of ``videoquery/testing/fake_api.py`` for the port, which imports
nothing of the JAX package.

The reference has zero integration tests because it can only run against the
external Django API (SURVEY.md §4). This fake implements the full coreapi
action surface the framework consumes (SURVEY.md Appendix A) over in-memory
tables, so the broker/ticket/loader paths are testable end-to-end, including
the process-state machine and the round-to-round query_result /
bootstrapped_target resume contract.

Job scheduling model (mirroring the API semantics the reference broker
observes): a query is picked up by
  - compute-new       when process_state == STATE_NEW_REQUESTED (1)
  - compute-revised   when process_state == STATE_REVISE_REQUESTED (2)
  - compute-finalize  when process_state == STATE_FINALIZE_REQUESTED (6)
and the update_object payload matches api_repository.py:25-43.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Mapping, Sequence

STATE_NEW_REQUESTED = 1
STATE_REVISE_REQUESTED = 2
STATE_FINALIZE_REQUESTED = 6

PAGE_SIZE = 50


class FakeAPI:
    """In-memory tables + the action surface."""

    def __init__(self):
        self._ids = itertools.count(1)
        self.videos: dict[int, dict] = {}
        self.video_clips: dict[int, dict] = {}
        self.features: dict[int, dict] = {}
        self.queries: dict[int, dict] = {}
        self.query_results: dict[int, dict] = {}
        self.matches: dict[int, dict] = {}
        self.search_sets: dict[int, dict] = {}
        self.uploaded_reports: dict[int, str] = {}

    def next_id(self) -> int:
        return next(self._ids)

    # -- content helpers (test setup) ----------------------------------------

    def add_video(self, name: str, path: str = "") -> dict:
        vid = {"id": self.next_id(), "name": name, "path": path}
        self.videos[vid["id"]] = vid
        return vid

    def add_clip(self, video_id: int, clip: int, duration: int = 10,
                 notes: str = "") -> dict:
        row = {
            "id": self.next_id(),
            "video": video_id,
            "clip": clip,
            "duration": duration,
            "notes": notes,
            "debug_video_uri": "",
        }
        self.video_clips[row["id"]] = row
        return row

    def add_feature(self, clip_id: int, stream: str, split: int,
                    vector: Sequence[float], name: str = "global_pool",
                    weights_uri: str = "") -> dict:
        row = {
            "id": self.next_id(),
            "video_clip": clip_id,
            "video_clip_id": clip_id,
            "dnn_stream": stream,
            "dnn_stream_id": stream,
            "dnn_stream_split": split,
            "name": name,
            "dnn_weights_uri": weights_uri,
            "feature_vector": list(map(float, vector)),
        }
        self.features[row["id"]] = row
        return row

    def add_search_set(self, name: str, clip_ids: Sequence[int]) -> dict:
        row = {"id": self.next_id(), "name": name, "clip_ids": list(clip_ids)}
        self.search_sets[row["id"]] = row
        return row

    def add_query(self, name: str, video_id: int, ref_clip: int,
                  ref_clip_id: int | None, search_set_id: int,
                  max_matches_for_review: int = 20,
                  dynamic_target_adjustment: bool = False,
                  reference_time: str = "0:00:00") -> dict:
        row = {
            "id": self.next_id(),
            "name": name,
            "video": video_id,
            "ref_clip": ref_clip,
            "ref_clip_id": ref_clip_id,
            "search_set_to_query": search_set_id,
            "max_matches_for_review": max_matches_for_review,
            "use_dynamic_target_adjustment": dynamic_target_adjustment,
            "reference_time": reference_time,
            "process_state": STATE_NEW_REQUESTED,
            "notes": "",
        }
        self.queries[row["id"]] = row
        return row

    def request_revision(self, query_id: int) -> None:
        self.queries[query_id]["process_state"] = STATE_REVISE_REQUESTED

    def request_finalize(self, query_id: int) -> None:
        self.queries[query_id]["process_state"] = STATE_FINALIZE_REQUESTED

    def set_user_match(self, match_id: int, value: bool) -> None:
        self.matches[match_id]["user_match"] = value

    # -- update_object assembly (api_repository.py:25-43 contract) -----------

    def _latest_result(self, query_id: int) -> dict | None:
        rounds = [r for r in self.query_results.values() if r["query"] == query_id]
        return max(rounds, key=lambda r: r["round"]) if rounds else None

    def _update_object(self, query: dict, with_history: bool) -> dict:
        obj = {
            "query_id": query["id"],
            "video_id": query["video"],
            "ref_clip": query["ref_clip"],
            "ref_clip_id": query["ref_clip_id"],
            "search_set": query["search_set_to_query"],
            "number_of_matches_to_review": query["max_matches_for_review"],
            "dynamic_target_adjustment": query["use_dynamic_target_adjustment"],
        }
        if with_history:
            latest = self._latest_result(query["id"])
            obj["latest_query_result"] = dict(latest) if latest else None
            if latest:
                bt = latest.get("bootstrapped_target")
                if bt:
                    # the real API hands back JSON; split keys arrive as
                    # strings and the repository converts them to ints
                    # (api_repository.py:65-78)
                    obj["latest_query_result"]["bootstrapped_target"] = bt
                prev = [
                    dict(m) for m in self.matches.values()
                    if m["query_result"] == latest["id"]
                ]
            else:
                prev = []
            obj["matches"] = prev
            user_matches: dict[str, bool] = {}
            for m in self.matches.values():
                q = self.query_results.get(m["query_result"])
                if q and q["query"] == query["id"] and m["user_match"] is not None:
                    user_matches[str(m["video_clip"])] = m["user_match"]
            obj["user_matches"] = user_matches
        return obj

    def _first_query_in_state(self, state: int) -> dict | None:
        for q in sorted(self.queries.values(), key=lambda q: q["id"]):
            if q["process_state"] == state:
                return q
        return None

    # -- the action surface ---------------------------------------------------

    def action(self, action: Sequence[str], params: Mapping[str, Any] | None = None,
               encoding: str | None = None) -> Any:
        params = dict(params or {})
        key = tuple(action)
        handler = {
            ("query-state", "compute-new", "list"): self._a_compute_new,
            ("query-state", "compute-revised", "list"): self._a_compute_revised,
            ("query-state", "compute-finalize", "list"): self._a_compute_finalize,
            ("queries", "read"): self._a_query_read,
            ("queries", "list"): self._a_queries_list,
            ("queries", "partial_update"): self._a_query_patch,
            ("videos", "list"): self._a_videos_list,
            ("videos", "read"): lambda p: dict(self.videos[p["id"]]),
            ("videos", "create"): self._a_videos_create,
            ("video-clips", "list"): self._a_clips_list,
            ("video-clips", "read"): lambda p: dict(self.video_clips[p["id"]]),
            ("video-clips", "create"): self._a_clips_create,
            ("video-clips", "features"): self._a_clip_features,
            ("features", "list"): self._a_features_list,
            ("features", "create"): self._a_features_create,
            ("search-sets", "read"): lambda p: dict(self.search_sets[p["id"]]),
            ("search-sets", "features"): self._a_search_set_features,
            ("query-results", "create"): self._a_qresult_create,
            ("query-results", "read"): lambda p: dict(self.query_results[p["id"]]),
            ("matches", "create"): self._a_match_create,
            ("matches", "list"): self._a_matches_list,
            # the human review UI records decisions with PATCH matches/<id>/
            ("matches", "partial_update"): self._a_match_patch,
        }.get(key)
        if handler is None:
            raise KeyError(f"fake API has no action {key}")
        return handler(params)

    def _a_compute_new(self, params):
        q = self._first_query_in_state(STATE_NEW_REQUESTED)
        return self._update_object(q, with_history=False) if q else None

    def _a_compute_revised(self, params):
        q = self._first_query_in_state(STATE_REVISE_REQUESTED)
        return self._update_object(q, with_history=True) if q else None

    def _a_compute_finalize(self, params):
        q = self._first_query_in_state(STATE_FINALIZE_REQUESTED)
        return self._update_object(q, with_history=True) if q else None

    def _a_query_read(self, params):
        return dict(self.queries[params["id"]])

    def _a_queries_list(self, params):
        # filterable listing (standard DRF surface; the broker's state-3
        # lease recovery scans with process_state=3, service/lease.py)
        rows = [dict(q) for q in sorted(self.queries.values(),
                                        key=lambda q: q["id"])
                if all(q.get(k) == params[k] for k in params)]
        return {"results": rows}

    def _a_query_patch(self, params):
        q = self.queries[params.pop("id")]
        report = params.pop("final_report_file", None)
        if report is not None:
            self.uploaded_reports[q["id"]] = report.read()
        q.update(params)
        return dict(q)

    def _a_videos_list(self, params):
        rows = [
            dict(v) for v in self.videos.values()
            if all(v.get(k) == params[k] for k in params)
        ]
        return {"results": rows}

    def _a_videos_create(self, params):
        return self.add_video(params["name"], params.get("path", ""))

    def _a_clips_list(self, params):
        id_in = None
        if "id__in" in params:
            id_in = {int(x) for x in str(params["id__in"]).split(",") if x}
        rows = []
        for c in self.video_clips.values():
            video = self.videos[c["video"]]
            if "video__name" in params and video["name"] != params["video__name"]:
                continue
            if "clip" in params and c["clip"] != params["clip"]:
                continue
            if "duration" in params and c["duration"] != params["duration"]:
                continue
            if id_in is not None and c["id"] not in id_in:
                continue
            rows.append(dict(c))
        return {"results": rows}

    def _a_clips_create(self, params):
        return self.add_clip(params["video"], params["clip"],
                             params.get("duration", 10))

    def _a_clip_features(self, params):
        cid = params["id"]
        return [dict(f) for f in self.features.values() if f["video_clip"] == cid]

    def _a_features_list(self, params):
        rows = []
        for f in self.features.values():
            if "video_clip" in params and f["video_clip"] != params["video_clip"]:
                continue
            if "dnn_stream" in params and f["dnn_stream"] != params["dnn_stream"]:
                continue
            if ("dnn_stream_split" in params
                    and f["dnn_stream_split"] != params["dnn_stream_split"]):
                continue
            rows.append(dict(f))
        return {"results": rows}

    def _a_features_create(self, params):
        return self.add_feature(
            params["video_clip"], params["dnn_stream"], params["dnn_stream_split"],
            params["feature_vector"], params.get("name", "global_pool"),
            params.get("dnn_weights_uri", ""),
        )

    def _a_search_set_features(self, params):
        ss = self.search_sets[params["id"]]
        clip_ids = set(ss["clip_ids"])
        return [dict(f) for f in self.features.values()
                if f["video_clip"] in clip_ids]

    def _a_qresult_create(self, params):
        row = {
            "id": self.next_id(),
            "round": params["round"],
            "match_criterion": params["match_criterion"],
            "weights": list(params["weights"]),
            "query": params["query"],
            "bootstrapped_target": params.get("bootstrapped_target"),
        }
        self.query_results[row["id"]] = row
        return dict(row)

    def _a_match_create(self, params):
        row = {
            "id": self.next_id(),
            "query_result": params["query_result"],
            "score": params["score"],
            "user_match": params.get("user_match"),
            # the API derives is_match from score >= the round's criterion
            "is_match": params["score"] >= self.query_results[
                params["query_result"]]["match_criterion"],
            "video_clip": params["video_clip"],
            "match_video_time_span": "{},{}".format(
                (self.video_clips[params["video_clip"]]["clip"] - 1)
                * self.video_clips[params["video_clip"]]["duration"],
                self.video_clips[params["video_clip"]]["clip"]
                * self.video_clips[params["video_clip"]]["duration"],
            ),
        }
        self.matches[row["id"]] = row
        return dict(row)

    def _a_match_patch(self, params):
        m = self.matches[params["id"]]
        # never mutate the caller's dict; only persist known match fields
        # (the real DRF API rejects unknown ones)
        unknown = set(params) - {"id", "score", "user_match", "is_match",
                                 "notes"}
        if unknown:
            raise KeyError(f"match patch: unknown fields {sorted(unknown)}")
        m.update({k: v for k, v in params.items() if k != "id"})
        return dict(m)

    def _a_matches_list(self, params):
        rows = [
            dict(m) for m in sorted(self.matches.values(), key=lambda m: m["id"])
            if m["query_result"] == params["query_result"]
            and ("video_clip" not in params or m["video_clip"] == params["video_clip"])
        ]
        page = params.get("page", 1)
        start = (page - 1) * PAGE_SIZE
        chunk = rows[start:start + PAGE_SIZE]
        next_page = page + 1 if start + PAGE_SIZE < len(rows) else None
        return {"results": chunk, "pagination": {"nextPage": next_page}}


class FakeClient:
    """Drop-in for service.client.ActionClient backed by a FakeAPI."""

    def __init__(self, api: FakeAPI):
        self.api = api

    def action(self, action, params=None, encoding=None):
        return self.api.action(action, params, encoding)


def latest_bootstrapped_target(api: FakeAPI, query_id: int) -> dict | None:
    rounds = [r for r in api.query_results.values() if r["query"] == query_id]
    if not rounds:
        return None
    latest = max(rounds, key=lambda r: r["round"])
    bt = latest.get("bootstrapped_target")
    return json.loads(bt) if bt else None
