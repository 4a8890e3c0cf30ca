"""Where an extraction batch's time goes, stage by stage.

Port of ``tools/extract_stages.py``. Times cumulative prefixes of the
port's ``extract_step`` at production geometry (8 clips x 150 frames at
340x256, 25 ticks, stacks of 5, the flow at half resolution with warm
groups of 3, 3 splits x 2 streams, bf16 networks as the JAX tool's
``build()`` has them):

  gray + flow-grid resize             _flow_gray_grid
  + warped TV-L1 + quantize           + _pair_flow (K3, K2)
  + tick/stack gathers + preprocess   prepare_step
  CNN ensemble alone (both streams)   embed_step on prepare_step's output
  FULL step                           extract_step

so the difference of adjacent cumulative rows is a stage's cost. Times from
``flow_bench.timeit`` (CUDA events on the card).

    python -m videoquery_torch.tools.extract_stages [--batch 8] [--reps 8] [--dtype bfloat16]
    python -m videoquery_torch.tools.extract_stages --device cpu --batch 1 --frames 20 \\
        --hw 64 96 --ticks 3 --splits 1 --resize 96 64 --crop 64
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from videoquery_torch.tools.flow_bench import full_f32, timeit


@dataclasses.dataclass
class Batch:
    """One extraction batch and what runs it."""

    frames: torch.Tensor        # u8 [B, F, H, W, 3] on the device
    plan: object                # extract.StepPlan
    cfg: object                 # ExtractionConfig
    tsn: object                 # TwoStreamTSN
    dtype: str


def build(batch: int = 8, frames: int = 150, hw=(256, 340), ticks: int = 25,
          depth: int = 5, res_div: int = 2, warm_group: int = 3,
          warm_camera: str | None = None, dtype: str = "bfloat16", splits=(1, 2, 3),
          resize=(340, 256), crop: int = 224, gray_matmul: bool = True, device=None,
          seed: int = 0) -> Batch:
    """Random u8 frames (the JAX tool's), the production config at these
    sizes, its step plan, and seeded random nets (TwoStreamTSN.random(0))."""
    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.nn.tsn import TwoStreamTSN
    from videoquery_torch.pipeline.extract import step_plan

    kw = {} if warm_camera is None else {"flow_warm_camera": warm_camera}
    cfg = ExtractionConfig(num_ticks=ticks, flow_stack_depth=depth, flow_res_div=res_div,
                           flow_warm_group=warm_group, frame_resize=tuple(resize),
                           crop_size=crop, batch_clips=batch, flow_gray_matmul=gray_matmul,
                           **kw)
    h, w = hw
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 255, (batch, frames, h, w, 3), np.uint8)).to(device)
    return Batch(x, step_plan(frames, cfg, "pallas", device), cfg,
                 TwoStreamTSN.random(0, tuple(splits), device), dtype)


def add_geometry_args(ap: argparse.ArgumentParser) -> None:
    """The batch geometry flags extract_stages and pipeline_overlap share."""
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--hw", type=int, nargs=2, default=[256, 340], metavar=("H", "W"))
    ap.add_argument("--ticks", type=int, default=25)
    ap.add_argument("--res_div", type=int, default=2)
    ap.add_argument("--warm_group", type=int, default=3)
    ap.add_argument("--warm_camera", default=None, choices=["own", "key", "init"],
                    help="the warm pairs' camera (default: ExtractionConfig's)")
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--resize", type=int, nargs=2, default=[340, 256], metavar=("W", "H"))
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, or VIDEOQUERY_DEVICE)")


def build_from_args(args, device) -> Batch:
    return build(args.batch, args.frames, tuple(args.hw), args.ticks, 5, args.res_div,
                 args.warm_group, args.warm_camera, args.dtype, tuple(args.splits),
                 tuple(args.resize), args.crop, not getattr(args, "gray_exact", False),
                 device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_geometry_args(ap)
    ap.add_argument("--gray_exact", action="store_true",
                    help="the f32 gray then resize instead of the two matmuls")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Time the rows, print them with the deltas; return them."""
    with full_f32():
        return _run(parse_args(argv))


def _run(args) -> dict:
    from videoquery_torch.core.device import resolve_device
    from videoquery_torch.pipeline.extract import (PRODUCTION_TVL1, _flow_gray_grid,
                                                   _pair_flow, embed_step,
                                                   extract_step, prepare_step)

    device = resolve_device(args.device)
    bt = build_from_args(args, device)
    cfg, plan, tvl1, reps = bt.cfg, bt.plan, PRODUCTION_TVL1, args.reps

    def s_gray(fr):
        return _flow_gray_grid(fr, cfg.flow_res_div, cfg.flow_gray_matmul)[0]

    def s_flow(fr):
        gray, vscale = _flow_gray_grid(fr, cfg.flow_res_div, cfg.flow_gray_matmul)
        return _pair_flow(gray, plan.pair_idx, cfg.flow_bound, True, tvl1, vscale,
                          plan.warm, cfg.flow_warm_camera)

    def s_inputs(fr):
        return prepare_step(fr, plan, cfg, True, tvl1, bt.dtype)

    rows = []
    t, _ = timeit(s_gray, bt.frames, reps=reps)
    rows.append(("gray", "gray + flow-grid resize", t))
    t, _ = timeit(s_flow, bt.frames, reps=reps)
    rows.append(("flow", f"+ warped TV-L1 (warm g{args.warm_group} "
                         f"cam={cfg.flow_warm_camera}) + quantize", t))
    t, inputs = timeit(s_inputs, bt.frames, reps=reps)
    rows.append(("inputs", "+ tick/stack gathers + preprocess", t))
    t, _ = timeit(embed_step, bt.tsn, *inputs, reps=reps)
    rows.append(("cnn", "CNN ensemble alone (both streams)", t))
    t, _ = timeit(extract_step, bt.tsn, bt.frames, plan, cfg, True, tvl1, bt.dtype,
                  reps=reps)
    rows.append(("full", "FULL step", t))

    print(f"batch {args.batch} x {args.frames} frames at {args.hw[0]}x{args.hw[1]}, "
          f"reps {reps}, warm g{args.warm_group} cam={cfg.flow_warm_camera}, "
          f"dtype {args.dtype}, splits {tuple(args.splits)}, on {device}")
    prev, out = 0.0, []
    for key, name, sec in rows:
        ms = sec * 1e3
        cumulative = key in ("gray", "flow", "inputs")
        delta = f"  (delta {ms - prev:+.3f} ms)" if cumulative else ""
        print(f"  {name:55s} {ms:9.3f} ms{delta}", flush=True)
        out.append({"row": key, "label": name, "ms": ms,
                    **({"delta_ms": ms - prev} if cumulative else {})})
        if cumulative:
            prev = ms
    t_in, t_cnn, t_full = rows[2][2], rows[3][2], rows[4][2]
    print(f"  => {args.batch / t_full:.2f} clips/s (inputs {t_in * 1e3:.3f} + cnn "
          f"{t_cnn * 1e3:.3f} = {(t_in + t_cnn) * 1e3:.3f} vs full {t_full * 1e3:.3f} ms)",
          flush=True)
    return {"device": str(device), "rows": out, "clips_per_s": args.batch / t_full}


def main(argv=None) -> None:
    print(json.dumps({"extract_stages": run(argv)}), flush=True)


if __name__ == "__main__":
    main()
