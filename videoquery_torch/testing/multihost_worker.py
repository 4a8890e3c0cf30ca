"""Worker process of the port's multi-process test world.

Port of ``videoquery/testing/multihost_worker.py``. Each worker joins a
``torch.distributed`` world (Gloo on the CPU, NCCL on a card; one rank a
device) and runs the three programs whose collectives cross the process
boundary:

  1. ShardedSearch top-k (the index split over the "data" axis, shard-local
     top-k, one all-gather of the [Q, k] candidates),
  2. two TSNTrainer steps with dropout 0.5 (the batch split over "data",
     DDP's gradient all-reduce),
  3. the data-sharded serving program: ``SearchEngine(index, mesh=mesh)``'s
     table, resident rounds and optimizer (``testing/sharded_serving.py``),

on the deterministic world of ``run_world`` and writes its results to
--out as JSON, so the spawning test can check that the workers agree, that
they equal a world of one rank and the unsharded engine, and that the
top-k ids equal the JAX package's world (tests/test_torch_multihost.py).

With ``--world extract`` it runs instead the sharded extractor
(``run_extract_world``): the same video through ``Extractor(mesh=...)`` on
a (data 2, model 1) and a (data 1, model 2) mesh of the two processes,
written to --out as an npz of every batch's signatures
(tests/test_torch_sharded_extract.py).

Run (each in its own process; --init_method takes the JAX worker's
--coordinator's place):
  python -m videoquery_torch.testing.multihost_worker \\
      --init_method file:///tmp/store --nprocs 2 --pid {0,1} --out r{0,1}.json \\
      --device cpu [--world extract]
"""

from __future__ import annotations

import argparse
import json
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init_method", required=True,
                    help="the rendezvous: tcp://host:port or file:///path")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="cuda:N (NCCL; the default is cuda:0) or cpu (Gloo)")
    ap.add_argument("--world", default="search_train", choices=("search_train", "extract"),
                    help="search_train: run_world; extract: run_extract_world")
    args = ap.parse_args()

    import torch.distributed as dist

    from videoquery_torch.core.meshes import initialize_multihost

    device = initialize_multihost(args.init_method, args.nprocs, args.pid, args.device)
    try:
        if args.world == "extract":
            import numpy as np

            np.savez(args.out, **run_extract_world(device))
            print(f"[worker {args.pid}] ok", flush=True)
            return
        result = run_world(device)
        result["world_size"] = dist.get_world_size()
        result["process_id"] = args.pid
        with open(args.out, "w") as f:
            json.dump(result, f)
        print(f"[worker {args.pid}] ok", flush=True)
    finally:
        dist.destroy_process_group()


def run_world(device) -> dict:
    """The deterministic world, in an initialized process group: the same
    numpy draws, in the same order, as the JAX package's ``run_world``, so
    the index, the targets and the training batch are equal to its. Then
    the data-sharded serving program (``testing/sharded_serving.py``) on
    the same mesh, and the unsharded engine's run of it in this process."""
    import numpy as np
    import torch

    from videoquery_torch.core.meshes import make_mesh
    from videoquery_torch.testing.sharded_serving import serving_world

    device = torch.device(device)
    # every rank along "data": the search's all-gather, the gradient
    # all-reduce and the serving program's collectives all cross the
    # process boundary
    mesh = make_mesh(device.type)
    rng = np.random.default_rng(0)
    vals, ids = search_world(mesh, rng)
    metrics, m2 = train_world(mesh, device, rng)
    return {
        "topk_vals": np.asarray(vals).tolist(),
        "topk_ids": np.asarray(ids).tolist(),
        "loss": metrics["loss"],
        "accuracy": metrics["accuracy"],
        "loss2": m2["loss"],
        "serving": serving_world(device, mesh),
        "serving_unsharded": serving_world(device),
    }


def search_world(mesh, rng, pad_multiple: int = 8):
    """ShardedSearch's top-5 of 3 queries over a 40-clip index of 16-d
    features (2 streams x 2 splits) drawn from ``rng``, padded to a
    multiple of ``pad_multiple`` (of the data axis): (vals, ids)."""
    from videoquery_torch.index.records import FeatureRecord
    from videoquery_torch.index.store import FeatureIndex
    from videoquery_torch.search.distributed import ShardedSearch

    streams = ("rgb", "warped_optical_flow")
    records = [
        FeatureRecord(cid, s, k, "global_pool", rng.normal(size=16))
        for cid in range(1, 41) for s in streams for k in (1, 2)
    ]
    index = FeatureIndex.build(records, streams, feature_dim=16,
                               pad_multiple=pad_multiple, device="cpu")
    search = ShardedSearch(index, mesh)
    targets = [
        {s: {k: rng.normal(size=16).tolist() for k in (1, 2)}
         for s in streams}
        for _ in range(3)
    ]
    weights = [{"rgb": 1.0, "warped_optical_flow": 1.5}] * 3
    return search.query_dicts(targets, weights, k=5)


def train_world(mesh, device, rng, videos: int = 8):
    """Two TSNTrainer steps (dropout 0.5, 2 segments, 7 classes) over the
    mesh's "data" axis on a batch of ``videos`` at 64x64 drawn from ``rng``:
    the two steps' metrics."""
    import numpy as np

    from videoquery_torch.nn import bn_inception
    from videoquery_torch.train.trainer import TrainConfig, TSNTrainer

    cfg = TrainConfig(num_segments=2, num_classes=7, dropout_rate=0.5)
    params = bn_inception.init_params(0, in_channels=3, num_classes=7)
    trainer = TSNTrainer(params, cfg, mesh=mesh, device=device)
    frames = rng.normal(size=(videos, 2, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 7, size=(videos,))
    return trainer.step(frames, labels, seed=0), trainer.step(frames, labels, seed=1)


def extract_world_video(n_frames: int = 46, h: int = 64, w: int = 80, seed: int = 0):
    """BGR u8 [n_frames, h, w, 3]: a textured scene panning 3 px a frame
    with a square crossing it at 12 px a frame: with extract_world_tvl1's
    trigger some pairs of the first batch are re-solved."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w * 4, 3)).astype(np.float32)
    for ax in (0, 1):
        base = (np.roll(base, 1, ax) + base + np.roll(base, -1, ax)) / 3.0
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    for i in range(n_frames):
        f = base[:, 3 * i:3 * i + w].copy()
        x0 = (12 * i) % (w - 16)
        f[24:40, x0:x0 + 16] = 250.0
        frames[i] = f.astype(np.uint8)
    return frames


# the extraction world's geometry: a 4-clip batch and a 1-clip tail; two
# splits a stream, warped TV-L1 on the pair path with the rescue on (its
# trigger lowered to 0.4 of the window, so that the rescue runs)
EXTRACT_WORLD = dict(fps=5, clip_seconds=2, num_ticks=4, frame_resize=(120, 96),
                     crop_size=64, batch_clips=4, min_tail_seconds=1)


def extract_world_tvl1():
    from videoquery_torch.kernels.tvl1 import TVL1Params

    return TVL1Params(n_scales=2, n_warps=1, n_iters=4, camera_model="homography",
                      rescue_frac=0.25, rescue_trigger=0.4)


def run_extract_world(device, meshes=((2, 1), (1, 2)), splits=(1, 2)) -> dict:
    """The sharded extractor on each (data, model) shape of ``meshes`` over
    the initialized world, with an ensemble of ``splits`` a stream: every
    batch's clip numbers and signatures, how many CSVs this rank wrote
    ({"<data>x<model>/<key>": array}), and on a model axis of 2 whether an
    ensemble of 3 splits was refused."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.core.meshes import DATA_AXIS, MODEL_AXIS
    from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN
    from videoquery_torch.pipeline.extract import Extractor, gather_signatures

    device = torch.device(device)
    tsn = TwoStreamTSN(StreamEnsemble.random(0, 3, splits, device),
                       StreamEnsemble.random(1, 10, splits, device))
    frames = extract_world_video()
    out = {}
    for data, model in meshes:
        assert data * model == dist.get_world_size()
        mesh = init_device_mesh(device.type, (data, model),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        ex = Extractor(tsn, ExtractionConfig(**EXTRACT_WORLD), warped=True,
                       tvl1=extract_world_tvl1(), device=device, mesh=mesh)
        sigs = gather_signatures(list(ex.extract_frames(frames)))
        tag = f"{data}x{model}"
        for i, s in enumerate(sigs):
            out[f"{tag}/{i}/clips"] = np.asarray(s.clip_numbers)
            out[f"{tag}/{i}/rgb"] = s.rgb
            out[f"{tag}/{i}/flow"] = s.flow
        with tempfile.TemporaryDirectory() as tmp:
            out[f"{tag}/csvs"] = np.asarray(len(ex.write_csv_tree(sigs, tmp, "v", "v.mp4")))
        if model == 2:
            # three splits cannot split over a model axis of two
            tsn3 = TwoStreamTSN(StreamEnsemble.random(0, 3, (1, 2, 3), device),
                                StreamEnsemble.random(1, 10, (1, 2, 3), device))
            try:
                Extractor(tsn3, ExtractionConfig(**EXTRACT_WORLD), device=device, mesh=mesh)
                out["refused_k3_over_model_2"] = np.asarray(0)
            except ValueError:
                out["refused_k3_over_model_2"] = np.asarray(1)
    return out


if __name__ == "__main__":
    sys.exit(main())
