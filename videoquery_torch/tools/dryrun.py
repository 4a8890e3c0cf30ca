"""The port's multi-device dry run: every program whose collectives cross
ranks, in one world (the twin of ``__graft_entry__.dryrun_multichip``).

    python -m videoquery_torch.tools.dryrun --world N [--device cpu|cuda] [--model_parallel M]

On the CPU it spawns N Gloo ranks through a ``file://`` store in a
temporary directory (``--world 2 --device cpu``). On cards, run it under
``torchrun --nproc_per_node N -m videoquery_torch.tools.dryrun --world N``:
each rank takes the card of its local rank over NCCL; without torchrun,
``--device cuda`` spawns the N ranks itself, rank r on cuda:r
(``--world 1``: this process alone). ``core/meshes.py::
initialize_multihost`` picks the backend from the device and never
switches it. The mesh is (data N / M, model M).

Each step prints one ``[dryrun]`` line (rank 0 prints):

1. two DDP train steps of ``TSNTrainer`` over "data": the loss;
2. the sharded ``Extractor(mesh=...)`` on a short synthetic video: finite
   signatures of the expected shapes;
3. with N >= 6, the 6-member ensemble (3 splits a stream) on a (data 2 x
   model 3) mesh of ranks 0-5 against the unsharded extractor (rtol 1e-5 /
   atol 1e-6, tests/test_torch_sharded_extract.py's tolerance);
4. ``ShardedSearch``'s top-5 of 3 queries over 40 clips;
5. the data-sharded serving program (``SearchEngine(index, mesh=mesh)``:
   tables, resident rounds solo and batched, optimize, selection) against
   the unsharded engine in the same process: bit for bit on cards, within
   ``sharded_serving.CPU_TOL`` on the CPU (selections equal).

It exits 1 when a step disagrees (or a rank fails), else 0 after
``[dryrun] OK``. ``__graft_entry__.entry()`` (a jitted function for XLA's
compile check) has no twin: the port compiles nothing ahead of time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

# seconds the spawned ranks may take together
SPAWN_TIMEOUT_S = 600.0


class Mismatch(AssertionError):
    """A step of the dry run disagrees with its reference."""


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, required=True, help="the number of ranks")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--model_parallel", type=int, default=1,
                    help='ranks along the mesh\'s "model" axis (must divide --world)')
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init_method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.world < 1 or args.world % args.model_parallel:
        ap.error(f"--model_parallel {args.model_parallel} must divide --world {args.world}")
    return args


def run_rank(device, world: int, model_parallel: int) -> None:
    """The five steps on an initialized world (module docstring); raises
    Mismatch when one disagrees."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from videoquery_torch.core.meshes import make_mesh
    from videoquery_torch.testing.multihost_worker import (run_extract_world,
                                                           search_world, train_world)
    from videoquery_torch.testing.sharded_serving import compare_serving, serving_world

    device = torch.device(device)
    rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    data = world // model_parallel
    mesh = make_mesh(device.type, model_parallel)
    rng = np.random.default_rng(0)

    m1, m2 = train_world(mesh, device, rng, videos=2 * max(data, 2))
    if not np.isfinite([m1["loss"], m2["loss"]]).all():
        raise Mismatch(f"train step loss not finite: {m1['loss']}, {m2['loss']}")
    say(f"[dryrun] train step on (data={data} x model={model_parallel}): "
        f"loss={m1['loss']:.4f}, then {m2['loss']:.4f}", flush=True)

    splits = (1, 2) if model_parallel <= 2 else tuple(range(1, model_parallel + 1))
    out = run_extract_world(device, meshes=((data, model_parallel),), splits=splits)
    tag = f"{data}x{model_parallel}"
    rgb = [v for k, v in out.items() if k.startswith(tag) and k.endswith("/rgb")]
    flow = [v for k, v in out.items() if k.startswith(tag) and k.endswith("/flow")]
    if not rgb or any(r.shape[0] != len(splits) or r.shape[2] != 1024 for r in rgb) \
            or not all(np.isfinite(a).all() for a in rgb + flow):
        raise Mismatch("sharded extraction: signatures missing, misshapen or not finite")
    say(f"[dryrun] sharded extraction on (data={data} x model={model_parallel}): "
        f"{len(rgb)} batches, rgb {rgb[0].shape} flow {flow[0].shape}", flush=True)

    if world >= 6:
        diff, bitwise = ensemble_on_six(device)
        if diff is not None:
            say(f"[dryrun] 6-member ensemble on (data=2 x model=3): sharded == unsharded "
                f"({'bit for bit' if bitwise else f'max |diff| {diff:.2e}'})", flush=True)
    else:
        say(f"[dryrun] 6-member ensemble on (data=2 x model=3): skipped, needs 6 ranks "
            f"(world {world})", flush=True)

    vals, ids = search_world(mesh, rng, pad_multiple=8 * data)
    if vals.shape != (3, 5) or not (ids > 0).all() or not np.isfinite(vals).all():
        raise Mismatch(f"sharded search top-5: {vals.shape}, ids {ids.tolist()}")
    say("[dryrun] sharded search top-5 over 40 clips: ok", flush=True)

    exact = device.type == "cuda"
    got = serving_world(device, mesh, pad_multiple=8 * data)
    want = serving_world(device, None, pad_multiple=8 * data)
    bad = compare_serving(got, want, exact=exact)
    if bad:
        raise Mismatch(f"sharded serving differs from the unsharded engine: {bad}")
    say(f"[dryrun] batched serving program (Q={len(got['rounds'])}) over {data} data "
        f"shards: == unsharded (table + resident rounds + optimize, "
        f"{'bit for bit' if exact else 'within CPU_TOL, selections equal'})", flush=True)
    say(f"[dryrun] OK on {world} ranks (data={data} x model={model_parallel}, "
        f"{dist.get_backend()})", flush=True)


def ensemble_on_six(device) -> tuple[float | None, bool]:
    """The 6-member ensemble (3 splits x 2 streams) through the sharded
    extractor on a (data 2 x model 3) mesh of ranks 0-5 and through the
    unsharded one, on ranks 0-5: (max |diff|, bitwise), or (None, False)
    on the other ranks, which take part in the mesh's making only. Raises
    Mismatch beyond rtol 1e-5 / atol 1e-6."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.core.meshes import DATA_AXIS, MODEL_AXIS
    from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN
    from videoquery_torch.pipeline.extract import Extractor, gather_signatures
    from videoquery_torch.testing.multihost_worker import (EXTRACT_WORLD,
                                                           extract_world_tvl1,
                                                           extract_world_video)

    mesh6 = DeviceMesh(device.type, torch.arange(6).reshape(2, 3),
                       mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    if dist.get_rank() >= 6:
        return None, False
    tsn = TwoStreamTSN(StreamEnsemble.random(3, 3, (1, 2, 3), device),
                       StreamEnsemble.random(4, 10, (1, 2, 3), device))
    frames = extract_world_video(n_frames=16)
    runs = []
    for mesh in (mesh6, None):
        ex = Extractor(tsn, ExtractionConfig(**EXTRACT_WORLD), warped=True,
                       tvl1=extract_world_tvl1(), device=device, mesh=mesh)
        runs.append(gather_signatures(list(ex.extract_frames(frames))))
    diff, bitwise = 0.0, True
    for a, b in zip(*runs):
        if a.clip_numbers != b.clip_numbers or a.rgb.shape != (3, len(a.clip_numbers), 1024):
            raise Mismatch(f"6-member ensemble: clips {a.clip_numbers} {b.clip_numbers}, "
                           f"rgb {a.rgb.shape}")
        for x, y in ((a.rgb, b.rgb), (a.flow, b.flow)):
            diff = max(diff, float(np.abs(x - y).max()))
            bitwise &= bool(np.array_equal(x, y))
            if not np.allclose(x, y, rtol=1e-5, atol=1e-6):
                raise Mismatch(f"6-member ensemble: sharded != unsharded ({diff:.2e})")
    return diff, bitwise


def join_and_run(args, rank: int, world: int, init_method: str, device: str) -> int:
    import torch.distributed as dist

    from videoquery_torch.core.meshes import initialize_multihost

    initialize_multihost(init_method, world, rank, device)
    try:
        run_rank(device, world, args.model_parallel)   # a Mismatch exits 1
    finally:
        dist.destroy_process_group()
    return 0


def spawn(args) -> int:
    """Start the N ranks of this command as processes, wait for all, stop
    the rest when one fails; rank r on cuda:r or the CPU."""
    with tempfile.TemporaryDirectory(prefix="vq_dryrun_") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "videoquery_torch.tools.dryrun", "--world", str(args.world),
             "--device", args.device, "--model_parallel", str(args.model_parallel),
             "--rank", str(r), "--init_method", init])
            for r in range(args.world)]
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    print(f"[dryrun] ranks still running after {SPAWN_TIMEOUT_S:.0f} s",
                          flush=True)
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            print(f"[dryrun] FAILED: rank exit codes {codes}", flush=True)
            return 1
        return 0


def main(argv=None) -> int:
    args = parse(argv)
    env_rank = os.environ.get("RANK")
    if env_rank is not None and args.rank is None:   # under torchrun
        world = int(os.environ["WORLD_SIZE"])
        if world != args.world:
            print(f"[dryrun] --world {args.world} but torchrun started {world} ranks",
                  flush=True)
            return 1
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = f"cuda:{local}" if args.device == "cuda" else "cpu"
        return join_and_run(args, int(env_rank), world, "env://", device)
    if args.rank is not None:                         # a rank spawned below
        device = f"cuda:{args.rank}" if args.device == "cuda" else "cpu"
        return join_and_run(args, args.rank, args.world, args.init_method, device)
    if args.world == 1:
        with tempfile.TemporaryDirectory(prefix="vq_dryrun_") as tmp:
            device = "cuda:0" if args.device == "cuda" else "cpu"
            return join_and_run(args, 0, 1, f"file://{os.path.join(tmp, 'store')}", device)
    return spawn(args)


if __name__ == "__main__":
    sys.exit(main())
