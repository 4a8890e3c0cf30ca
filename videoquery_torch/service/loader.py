"""DB ingest: feature-CSV tree -> video/clip/feature records.

Covers the reference's load_db.py + api_load_records.py: walk the two-level
``<src>/<video>/<split_dir>/`` tree and idempotently create-or-get videos,
clips and features (load_db.py:16-28, api_load_records.py:20-113).

Improvement over the reference's 2+ HTTP round-trips per (clip, stream,
split) — the ingest bottleneck (SURVEY.md §3.4): rows are still written
record-by-record through the same action surface for API compatibility, but
parsing is batched per CSV (optionally via the native C++ parser) and a
local-index fast path (`load_index`) builds a device FeatureIndex directly
from the tree with no API at all; `--shard_out` writes that index as
binary `.vqidx` shards (index/persist.py), and with `--no_api` the loader
does only that.
"""

from __future__ import annotations

import logging
import os
from typing import Literal

import torch

from videoquery_torch.core.config import HyperParams
from videoquery_torch.index.csvio import read_feature_tree
from videoquery_torch.index.records import FeatureRecord
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.service.client import ActionClient

log = logging.getLogger(__name__)


class DBLoader:
    def __init__(self, client: ActionClient):
        self.client = client

    def create_or_get_video(self, name: str, path: str) -> dict:
        """Idempotent create (api_load_records.py:20-39)."""
        response = self.client.action(["videos", "list"], {"name": name, "path": path})
        if response["results"]:
            assert len(response["results"]) == 1
            return self.client.action(
                ["videos", "read"], {"id": response["results"][0]["id"]}
            )
        return self.client.action(["videos", "create"], {"name": name, "path": path})

    def _create_or_get_clip(self, clip: int, duration: int, video: dict) -> int:
        response = self.client.action(
            ["video-clips", "list"],
            {"video__name": video["name"], "clip": clip, "duration": duration},
        )
        if response["results"]:
            assert len(response["results"]) == 1
            obj = self.client.action(
                ["video-clips", "read"], {"id": response["results"][0]["id"]}
            )
        else:
            obj = self.client.action(
                ["video-clips", "create"],
                {
                    "clip": clip,
                    "duration": duration,
                    "debug_video_uri": video["path"],
                    "video": video["id"],
                },
            )
        return obj["id"]

    def _create_feature(self, vector, split: int, name: str, weights_uri: str,
                        clip_id: int, stream: str) -> None:
        response = self.client.action(
            ["features", "list"],
            {"video_clip": clip_id, "dnn_stream": stream, "dnn_stream_split": split},
        )
        if response["results"]:
            assert len(response["results"]) == 1
            return
        self.client.action(
            ["features", "create"],
            {
                "dnn_stream_split": split,
                "name": name,
                "dnn_weights_uri": weights_uri,
                "feature_vector": list(map(float, vector)),
                "video_clip": clip_id,
                "dnn_stream": stream,
            },
        )

    def load_tree(
        self,
        src_dir: str,
        duration: int = 10,
        video_path_type: Literal["absolute", "relative"] = "absolute",
    ) -> int:
        """Walk the feature tree and push every record (load_db.py:10-28).
        Returns the number of feature rows processed. Idempotent: rerunning
        resumes (SURVEY.md §5.4)."""
        n = 0
        for video_name, split, csvf in read_feature_tree(src_dir):
            video_path = (
                os.path.join(os.path.abspath(src_dir), video_name)
                if video_path_type == "absolute"
                else os.path.join(src_dir, video_name)
            )
            video = self.create_or_get_video(csvf.video, video_path)
            for clip_no, vec in zip(csvf.clip_numbers, csvf.features):
                clip_id = self._create_or_get_clip(int(clip_no), duration, video)
                self._create_feature(
                    vec, split, csvf.feature_blob, csvf.weights_uri,
                    clip_id, csvf.stream,
                )
                n += 1
        return n


def load_index(src_dir: str, hp: HyperParams | None = None,
               workers: int = 8, *, device: torch.device | str,
               **build_kwargs) -> FeatureIndex:
    """API-free fast path: build a FeatureIndex on `device` straight from
    a feature-CSV tree, assigning synthetic clip ids in (video, clip) order.
    CSVs parse in parallel (the native parser releases the GIL)."""
    from videoquery_torch.index.csvio import read_feature_tree_parallel

    hp = hp or HyperParams()
    records = []
    clip_key_to_id: dict[tuple[str, int], int] = {}
    for video_name, split, csvf in read_feature_tree_parallel(src_dir, workers):
        for clip_no, vec in zip(csvf.clip_numbers, csvf.features):
            key = (video_name, int(clip_no))
            if key not in clip_key_to_id:
                clip_key_to_id[key] = len(clip_key_to_id) + 1
            records.append(
                FeatureRecord(
                    clip_key_to_id[key], csvf.stream, split,
                    csvf.feature_blob, vec,
                )
            )
    return FeatureIndex.build(records, hp.streams, device=device, **build_kwargs)


def main(argv=None) -> None:
    """CLI mirroring the reference (load_db.py:32-39)."""
    import argparse

    from videoquery_torch.service.client import HTTPTransport

    parser = argparse.ArgumentParser(
        description="Load feature CSVs into the Video Query API database"
    )
    parser.add_argument("src_dir", help="feature tree root")
    parser.add_argument("--duration", type=int, default=10,
                        help="clip duration in seconds, default 10")
    parser.add_argument("--video_path_type", default="absolute",
                        choices=["absolute", "relative"])
    parser.add_argument("--base_url", default="http://127.0.0.1:8000/")
    parser.add_argument("--shard_out", default=None,
                        help="also write binary .vqidx embedding shards here "
                             "(the production index format; no API needed "
                             "when used with --no_api)")
    parser.add_argument("--no_api", action="store_true",
                        help="skip the REST ingest; only build local shards")
    args = parser.parse_args(argv)
    if args.shard_out:
        from videoquery_torch.index.persist import save_index

        # the shards are written from host arrays: the index is built on the
        # host and never touches the card
        index = load_index(args.src_dir, device="cpu")
        paths = save_index(index, args.shard_out)
        log.info("wrote %d embedding shard(s) for %d clips to %s",
                 len(paths), index.n_clips, args.shard_out)
        print(f"wrote {len(paths)} shard(s), {index.n_clips} clips -> {args.shard_out}")
    if args.no_api:
        return
    loader = DBLoader(ActionClient(HTTPTransport(args.base_url)))
    n = loader.load_tree(args.src_dir, args.duration, args.video_path_type)
    log.info("loaded %d feature rows", n)


if __name__ == "__main__":
    main()
