"""Worker process of the port's multi-process test world.

Port of ``videoquery/testing/multihost_worker.py``. Each worker joins a
``torch.distributed`` world (Gloo on the CPU, NCCL on a card; one rank a
device) and runs the two programs whose collectives cross the process
boundary:

  1. ShardedSearch top-k (the index split over the "data" axis, shard-local
     top-k, one all-gather of the [Q, k] candidates),
  2. two TSNTrainer steps with dropout 0.5 (the batch split over "data",
     DDP's gradient all-reduce),

on the deterministic world of ``run_world`` and writes its results to
--out as JSON, so the spawning test can check that the workers agree, that
they equal a world of one rank, and that the top-k ids equal the JAX
package's world (tests/test_torch_multihost.py).

Run (each in its own process; --init_method takes the JAX worker's
--coordinator's place):
  python -m videoquery_torch.testing.multihost_worker \\
      --init_method file:///tmp/store --nprocs 2 --pid {0,1} --out r{0,1}.json \\
      --device cpu
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
    args = ap.parse_args()

    import torch.distributed as dist

    from videoquery_torch.core.meshes import initialize_multihost

    device = initialize_multihost(args.init_method, args.nprocs, args.pid, args.device)
    try:
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
    the index, the targets and the training batch are equal to its."""
    import numpy as np
    import torch

    from videoquery_torch.core.meshes import make_mesh
    from videoquery_torch.index.records import FeatureRecord
    from videoquery_torch.index.store import FeatureIndex
    from videoquery_torch.nn import bn_inception
    from videoquery_torch.search.distributed import ShardedSearch
    from videoquery_torch.train.trainer import TrainConfig, TSNTrainer

    device = torch.device(device)
    # every rank along "data": the search's all-gather and the gradient
    # all-reduce both cross the process boundary
    mesh = make_mesh(device.type)
    rng = np.random.default_rng(0)
    streams = ("rgb", "warped_optical_flow")
    records = [
        FeatureRecord(cid, s, k, "global_pool", rng.normal(size=16))
        for cid in range(1, 41) for s in streams for k in (1, 2)
    ]
    index = FeatureIndex.build(records, streams, feature_dim=16, pad_multiple=8,
                               device="cpu")
    search = ShardedSearch(index, mesh)
    targets = [
        {s: {k: rng.normal(size=16).tolist() for k in (1, 2)}
         for s in streams}
        for _ in range(3)
    ]
    weights = [{"rgb": 1.0, "warped_optical_flow": 1.5}] * 3
    vals, ids = search.query_dicts(targets, weights, k=5)

    cfg = TrainConfig(num_segments=2, num_classes=7, dropout_rate=0.5)
    params = bn_inception.init_params(0, in_channels=3, num_classes=7)
    trainer = TSNTrainer(params, cfg, mesh=mesh, device=device)
    frames = rng.normal(size=(8, 2, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 7, size=(8,))
    metrics = trainer.step(frames, labels, seed=0)
    m2 = trainer.step(frames, labels, seed=1)

    return {
        "topk_vals": np.asarray(vals).tolist(),
        "topk_ids": np.asarray(ids).tolist(),
        "loss": metrics["loss"],
        "accuracy": metrics["accuracy"],
        "loss2": m2["loss"],
    }


if __name__ == "__main__":
    sys.exit(main())
