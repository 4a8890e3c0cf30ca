"""Strong scaling of the sharded extraction step over a world of N ranks.

Port of ``tools/scaling_curve.py``. The same total clip batch runs through
``Extractor(mesh=...)``'s batch step (``_dispatch_payload``: the rank's
data shard of the clips uploaded, its flow on K3 and K2, its share of the
networks, the all-gather of the signatures) on worlds of N ranks, one
process a rank, spawned by this tool and joined through a ``file://``
store in a temporary directory. It prints each world's seconds a step and
t(1)/t(N); with ``--diag`` the step split into the full step, the CNN
alone (the rank's tick frames through its ensemble), the flow alone (the
rank's pairs) and an elementwise control of the same batch shape that
moves nothing between ranks, so a loss the control shows too is the
world's, not the program's.

The step is the production one by default: ExtractionConfig() (25 ticks,
stacks of 5, the flow at half resolution with warm groups of 3),
PRODUCTION_TVL1, 8 clips x 150 frames at 340x256, 3 splits x 2 streams,
f32 networks (``--dtype bfloat16`` for T1's route). ``--tvl1 modest`` is
the JAX tool's schedule (3 scales, 2 warps, 8 iterations), for a
program-structure run at a small size.

Two devices:
- ``--device cpu``: Gloo, N = 1, 2, 4, one intra-op thread a rank (N
  ranks use N cores, so the ideal t(1)/t(N) is N while the host has N
  free cores). A program-structure measurement, as the JAX tool's virtual
  CPU mesh; pass a small size, the production step takes minutes there.
- ``--device cuda``: NCCL, one rank a card, N up to the card count (NCCL
  refuses two ranks on one card, so one card gives N = 1 only).

A step's time is the slowest rank's, on the host clock around a
synchronised step. Nothing is written unless ``--out`` names a file.

    python -m videoquery_torch.tools.scaling_curve --device cuda [--diag] [--dtype bfloat16]
    python -m videoquery_torch.tools.scaling_curve --device cpu --diag --tvl1 modest \
        --frames 20 --hw 96 128 --ticks 5 --splits 1
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORLD_TIMEOUT_S = 300    # a world's ranks are killed after this


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--ranks", type=int, nargs="+", default=None,
                    help="world sizes (default: 1 2 4 on the CPU, powers of two up "
                         "to the card count on CUDA)")
    ap.add_argument("--diag", action="store_true",
                    help="split the step: full, cnn, flow and an elementwise control")
    ap.add_argument("--batch_clips", type=int, default=8)
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 340), metavar=("H", "W"))
    ap.add_argument("--resize", type=int, nargs=2, default=(340, 256), metavar=("W", "H"))
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--ticks", type=int, default=25)
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--tvl1", default="production", choices=["production", "modest"],
                    help="PRODUCTION_TVL1, or the JAX tool's 3 scales x 2 warps x 8 "
                         "iterations")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the rows here as JSON")
    # one rank of a world (this tool spawns them)
    ap.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init_method", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def measure(args) -> dict:
    """One rank of a world of args.world: the sharded step (and with
    --diag its split), each the slowest rank's seconds a rep."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.core.meshes import (DATA_AXIS, all_gather_cat,
                                              initialize_multihost, make_mesh)
    from videoquery_torch.kernels import inception_block as t1
    from videoquery_torch.kernels import tvl1_level as k2, window_warp as k3
    from videoquery_torch.kernels.tvl1 import TVL1Params
    from videoquery_torch.nn.tsn import TwoStreamTSN
    from videoquery_torch.pipeline.extract import (DTYPES, PRODUCTION_TVL1, DataShard,
                                                   Extractor, _flow_gray_grid,
                                                   _pair_flow_uv, ensemble_embed)
    from videoquery_torch.pipeline.payload import BatchPayload
    from videoquery_torch.pipeline.preprocess import preprocess_rgb

    if args.device == "cpu":
        torch.set_num_threads(1)
        device = "cpu"
    else:
        device = f"cuda:{args.rank}"
    device = initialize_multihost(args.init_method, args.world, args.rank, device)
    try:
        mesh = make_mesh(device.type)
        group = mesh.get_group(DATA_AXIS)
        b, f, (h, w) = args.batch_clips, args.frames, args.hw
        tvl1 = (PRODUCTION_TVL1 if args.tvl1 == "production"
                else TVL1Params(n_scales=3, n_warps=2, n_iters=8))
        cfg = ExtractionConfig(num_ticks=args.ticks, batch_clips=b,
                               frame_resize=tuple(args.resize), crop_size=args.crop)
        tsn = TwoStreamTSN.random(0, tuple(args.splits), device)
        rng = np.random.default_rng(0)
        frames = rng.integers(0, 255, (b, f, h, w, 3), np.uint8)
        payload = BatchPayload(list(range(1, b + 1)), f, frames, None, None)
        ex = Extractor(tsn, cfg, warped=True, tvl1=tvl1, device=device, dtype=args.dtype,
                       mesh=mesh)
        rows = DataShard.of(group, args.rank, args.world, b).take()

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        def seconds(fn) -> float:
            fn()
            sync()
            dist.barrier(group)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            sync()
            dt = (time.perf_counter() - t0) / args.reps
            return float(all_gather_cat(torch.tensor([dt], device=device), group).max())

        out = {"ranks": args.world, "device": args.device}
        out["full_s"] = seconds(lambda: ex._dispatch_payload(payload))
        # the kernels' launches of the full step (a rank's, warm-up included)
        out["launches"] = {"K2": k2.LAUNCHES, "K3": k3.LAUNCHES, "T1": t1.LAUNCHES}
        if args.diag:
            plan = ex._plan(f)
            mine = torch.from_numpy(frames[rows]).to(device)
            ticks = mine[:, plan.tick_idx]

            def cnn():
                x = preprocess_rgb(ticks, cfg.frame_resize, cfg.crop_size,
                                   dtype=DTYPES[args.dtype])
                return ensemble_embed(tsn.rgb, x.reshape((-1,) + x.shape[2:]), mesh)

            gray, _ = _flow_gray_grid(mine, cfg.flow_res_div, cfg.flow_gray_matmul)

            def flow():
                return _pair_flow_uv(gray, plan.pair_idx, True, tvl1, plan.warm,
                                     cfg.flow_warm_camera)

            gen = torch.Generator(device).manual_seed(0)
            big = torch.randn((len(rows), 4 * f * h * w // 64, 64), generator=gen,
                              device=device)

            def control():
                x = big
                for _ in range(30):
                    x = torch.tanh(x) * 1.0001 + 0.0001
                return x

            out["cnn_s"] = seconds(cnn)
            out["flow_s"] = seconds(flow)
            out["control_s"] = seconds(control)
        return out
    finally:
        dist.destroy_process_group()


def spawn_world(args, n: int) -> dict:
    """Run a world of n ranks as n processes; rank 0's result."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="vq_scaling_") as tmp:
        common = [sys.executable, "-m", "videoquery_torch.tools.scaling_curve",
                  "--device", args.device, "--world", str(n),
                  "--init_method", f"file://{os.path.join(tmp, 'store')}",
                  "--batch_clips", str(args.batch_clips), "--frames", str(args.frames),
                  "--hw", *map(str, args.hw), "--resize", *map(str, args.resize),
                  "--crop", str(args.crop), "--ticks", str(args.ticks),
                  "--splits", *map(str, args.splits), "--dtype", args.dtype,
                  "--tvl1", args.tvl1, "--reps", str(args.reps)] \
            + (["--diag"] if args.diag else [])
        procs = [subprocess.Popen(common + ["--rank", str(r)], env=env, cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for p, lg in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"a rank of the {n}-rank world failed:\n{lg[-3000:]}")
    line = [ln for ln in logs[0].splitlines() if ln.startswith("{")]
    return json.loads(line[-1])


def run(argv=None) -> dict:
    """Every world size's step, t(1)/t(N); printed, returned, and written
    to --out if named."""
    args = parse_args(argv)
    if args.world:
        return measure(args)
    ranks = args.ranks
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("--device cuda needs a CUDA device")
        ranks = ranks or [n for n in (1, 2, 4, 8) if n <= cards]
        if max(ranks) > cards:
            raise ValueError(f"NCCL takes one rank a card: {max(ranks)} ranks, {cards} cards")
    ranks = ranks or [1, 2, 4]
    print(f"step: {args.batch_clips} clips x {args.frames} frames at {args.hw[0]}x{args.hw[1]}, "
          f"{args.ticks} ticks, splits {tuple(args.splits)}, {args.dtype}, {args.tvl1} TV-L1",
          flush=True)
    rows = []
    for n in ranks:
        row = spawn_world(args, n)
        row["speedup_vs_1"] = rows[0]["full_s"] / row["full_s"] if rows else 1.0
        rows.append(row)
        split = ("  " + ", ".join(f"{k[:-2]} {row[k]:.4f} s" for k in
                                  ("cnn_s", "flow_s", "control_s")) if args.diag else "")
        print(f"{n} rank(s) on {args.device}: {row['full_s']:.4f} s a step, t(1)/t({n}) "
              f"{row['speedup_vs_1']:.3f}{split}", flush=True)
    result = {"mode": f"strong scaling, {args.batch_clips} clips a step in all, "
                      f"{args.device}", "batch_clips": args.batch_clips,
              "geometry": {"frames": args.frames, "hw": list(args.hw), "ticks": args.ticks,
                           "splits": args.splits, "dtype": args.dtype, "tvl1": args.tvl1},
              "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    return result


def main(argv=None) -> None:
    out = run(argv)
    print(json.dumps(out if "rows" not in out else {"scaling_curve": out}), flush=True)


if __name__ == "__main__":
    main()
