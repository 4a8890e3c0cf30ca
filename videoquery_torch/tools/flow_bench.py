"""Micro-benchmark of the warped TV-L1 flow at production geometry.

Port of ``tools/flow_bench.py``. Splits the cost of the production warped
flow (``PRODUCTION_TVL1`` at the 128x128 flow grid, 500 pairs) into its
stages: the camera estimate (coarse cross-correlation and LK on K3), the
camera warp (an integer roll and K3), the pyramid on K2, and the whole
warped and plain flow at each ``--sweep`` size; ``--levels`` times each
pyramid level alone (one K2 call at the level's window), ``--warm`` the
warm-start path (groups 5 and 3, the production warm camera) against cold.

Times come from ``timeit``, the helper the extraction tools share: CUDA
events around the calls on the card, the host clock around synchronised
calls on the CPU.

    python -m videoquery_torch.tools.flow_bench [--pairs 500] [--levels] [--warm]
    python -m videoquery_torch.tools.flow_bench --device cpu --pairs 8 --hw 32 32
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree


@contextlib.contextmanager
def full_f32():
    """TF32 off for the body, as the extraction entry points run (the
    camera's cross-correlation argmax moves under it), and the caller's
    flags back after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _device_of(out) -> torch.device | None:
    for leaf in pytree.tree_leaves(out):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def timeit(fn, *args, reps: int = 10, **kw):
    """(seconds a call, the last output) of ``reps`` calls of fn(*args,
    **kw) after one warm-up call: CUDA events around the calls when the
    output is on a CUDA device (host gaps between launches count, as the
    card waits through them), else the host clock around them with the
    device synchronised."""
    out = fn(*args, **kw)
    dev = _device_of(out)
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            out = fn(*args, **kw)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
    return (time.perf_counter() - t0) / reps, out


def make_inputs(n: int, h: int, w: int, device, seed: int = 0):
    """Video-like f32 pairs [n, h, w]: a smooth random texture and a copy
    shifted by (2, -1) px with a little noise (TV-L1 on pure noise is
    unrepresentative)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(n, h + 16, w + 16).astype(np.float32)
    for ax in (1, 2):
        base = (np.roll(base, 1, ax) + base + np.roll(base, -1, ax)) / 3.0
    i0 = base[:, 8:8 + h, 8:8 + w]
    i1 = base[:, 6:6 + h, 9:9 + w] + rng.rand(n, h, w).astype(np.float32) * 0.01
    return (torch.from_numpy(np.ascontiguousarray(i0)).to(device),
            torch.from_numpy(np.ascontiguousarray(i1)).to(device))


def in_calls(fn, pairs: tuple, per_call: int, *args, **kw):
    """fn(*pairs, *args, **kw) over the pairs in calls of ``per_call``
    pairs: each tensor of ``pairs`` is sliced along its first axis."""
    n = pairs[0].shape[0]
    outs = [fn(*(t[s:s + per_call] for t in pairs), *args, **kw)
            for s in range(0, n, per_call)]
    return [torch.cat(parts) for parts in zip(*outs)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=500)
    ap.add_argument("--hw", type=int, nargs=2, default=[128, 128])
    ap.add_argument("--sweep", type=int, nargs="+", default=[500, 125, 32],
                    help="pairs a call of the whole flow. The JAX tool's G is "
                         "pairs a Pallas program; K2's band route runs one "
                         "thread-block cluster a pair whatever the call's size, "
                         "so here G is the pairs handed to one call")
    ap.add_argument("--levels", action="store_true", help="time each pyramid level")
    ap.add_argument("--warm", action="store_true",
                    help="time the warm-start path (groups 5 and 3) against cold "
                         "at the production schedule")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, or VIDEOQUERY_DEVICE; 'cpu' "
                         "runs the kernels' plain versions)")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Time the rows the flags pick (TF32 off, the caller's flags back
    after); print one line a row; return them."""
    with full_f32():
        return _run(parse_args(argv))


def _run(args) -> dict:
    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.core.device import resolve_device
    from videoquery_torch.kernels.tvl1 import _pyramid_shapes
    from videoquery_torch.kernels.tvl1_flow import (_level_disp, apply_camera,
                                                    estimate_camera, tvl1_flow,
                                                    tvl1_warped_flow)
    from videoquery_torch.kernels.tvl1_level import tvl1_level
    from videoquery_torch.kernels.resize import resize2
    from videoquery_torch.pipeline.extract import PRODUCTION_TVL1, _pair_flow_uv
    from videoquery_torch.pipeline.sampling import flow_warm_plan

    device = resolve_device(args.device)
    n, (h, w), p, reps = args.pairs, args.hw, PRODUCTION_TVL1, args.reps
    i0, i1 = make_inputs(n, h, w, device)
    rows = []

    def row(name, sec, pairs=n, **extra):
        rows.append({"row": name, "ms": sec * 1e3, "pairs": pairs, **extra})
        print(f"{name:58s} {sec * 1e3:9.3f} ms ({pairs / sec:9.1f} pairs/s)", flush=True)

    print(f"== {n} pairs at {h}x{w}, {p.n_scales} levels, {p.n_warps} warps "
          f"({p.fine_warps} fine), {p.n_iters} iters ({p.fine_iters} fine), "
          f"camera {p.camera_model}, on {device}")
    if args.warm:
        # consecutive pairs of one "video": gray[t + 1] follows gray[t]
        gray = torch.cat([i0[:1], i1])[None]                    # [1, n + 1, h, w]
        pair_idx = np.arange(n)
        warm_camera = ExtractionConfig().flow_warm_camera      # what ships
        for wg in (0, 5, 3):
            plan = None
            if wg:
                plan = tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                             for a in flow_warm_plan(pair_idx, wg))
            sec, _ = timeit(_pair_flow_uv, gray, torch.as_tensor(pair_idx, device=device),
                            True, p, plan, warm_camera, reps=reps)
            row(f"warped production, warm g{wg} cam={warm_camera}" if wg
                else "warped production, cold", sec, warm_group=wg)
        return {"device": str(device), "rows": rows}

    sec, cam = timeit(estimate_camera, i0, i1, p, reps=reps)
    row("camera estimate (coarse xcorr + 6 LK steps on K3)", sec)
    sec, i1w = timeit(apply_camera, i1, cam, reps=reps)
    row("camera warp (roll + K3, d=4)", sec)
    sec, _ = timeit(tvl1_flow, i0, i1w, p, 8, reps=reps)
    row("pyramid on the warped pairs (K2, d=8)", sec)
    for g in args.sweep:
        sec, _ = timeit(in_calls, tvl1_warped_flow, (i0, i1), g, p, max_disp=8, reps=reps)
        row(f"warped flow, {g} pairs a call", sec, per_call=g)
    for g in args.sweep:
        sec, _ = timeit(in_calls, tvl1_flow, (i0, i1), g, p, max_disp=8, reps=reps)
        row(f"plain flow, {g} pairs a call", sec, per_call=g)
    if args.levels:
        for g in args.sweep:
            for lv, (lh, lw) in enumerate(_pyramid_shapes(h, w, p)):
                li0 = resize2(i0, (lh, lw)).contiguous()
                li1 = resize2(i1, (lh, lw)).contiguous()
                u = torch.zeros_like(li0)
                d = _level_disp(8, p, lv)
                pl = p.at_level(lv)
                sec, _ = timeit(in_calls, tvl1_level, (li0, li1, u, u), g, pl, d, reps=reps)
                row(f"  level {lv} ({lh}x{lw}, d={d}, {pl.n_warps} warps x {pl.n_iters} "
                    f"iters), {g} a call", sec, per_call=g, level=lv)
    return {"device": str(device), "rows": rows}


def main(argv=None) -> None:
    print(json.dumps({"flow_bench": run(argv)}), flush=True)


if __name__ == "__main__":
    main()
