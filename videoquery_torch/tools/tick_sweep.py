"""Tick budget against retrieval: clips/s and motion retrieval by ticks.

Port of ``tools/tick_sweep.py``. The 25-tick budget (calcSig_wOF.py:67-72)
sets most of an extraction batch's cost (25 ticks: 125 flow pairs and 200
CNN images an 8-clip batch). Ticks are a sampling question, so the gate is
retrieval: partner accuracy of the flow and rgb embeddings on
``flow_quality``'s synthetic corpus with production-length clips (150
frames), over ``--ticks``, beside clips/s at each tick count from this
tool's own timed batches (8 clips x 150 frames at 340x256, the production
flow and bf16 nets: ``bench_batches``; the JAX tool calls its package's
bench). 25 stays the shipping default.

    python -m videoquery_torch.tools.tick_sweep [--seeds 0 1 2] [--ticks 25 15 10 5]
    python -m videoquery_torch.tools.tick_sweep --device cpu --seeds 0 --ticks 3 2 \\
        --frames 20 --size 48 64 --resize 96 64 --crop 64 --batch_clips 1 \\
        --bench_hw 64 96 --bench_splits 1
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from videoquery_torch.tools.flow_bench import full_f32


def embeddings_for_ticks(clips: np.ndarray, num_ticks: int, tsn, device,
                         resize=(340, 256), crop: int = 224, chunk: int = 4):
    """The production step's embeddings (f64 [K, C, D] a stream) of the
    corpus at a tick budget, in chunks of ``chunk`` clips (a short last
    chunk padded with its last clip: one geometry), f32 networks."""
    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.pipeline.extract import PRODUCTION_TVL1, extract_step, step_plan

    c, f = clips.shape[:2]
    cfg = ExtractionConfig(num_ticks=num_ticks, frame_resize=tuple(resize), crop_size=crop)
    plan = step_plan(f, cfg, "pallas", device)
    rgb_all, flow_all = [], []
    for s in range(0, c, chunk):
        part = clips[s:s + chunk]
        if len(part) < chunk:
            part = np.concatenate([part, np.repeat(part[-1:], chunk - len(part), axis=0)])
        rgb, flow = extract_step(tsn, torch.from_numpy(part).to(device), plan, cfg, True,
                                 PRODUCTION_TVL1, "float32")
        rgb_all.append(rgb.double().cpu().numpy())
        flow_all.append(flow.double().cpu().numpy())
    return (np.concatenate(rgb_all, axis=1)[:, :c],
            np.concatenate(flow_all, axis=1)[:, :c])


def bench_batches(num_ticks: int, device, batch_clips: int = 8, frames: int = 150,
                  hw=(256, 340), splits=(1, 2, 3), dtype: str = "bfloat16",
                  resize=(340, 256), crop: int = 224, reps: int = 3) -> float:
    """Clips/s of the production step at a tick count: an 8-clip batch of
    150 textured frames at 340x256 (a blurred random scene under a pan,
    so the flow has motion to solve), the production flow, bf16 nets of 3
    splits; mean of ``reps`` batches after a warm-up (flow_bench.timeit)."""
    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.nn.tsn import TwoStreamTSN
    from videoquery_torch.pipeline.extract import PRODUCTION_TVL1, extract_step, step_plan
    from videoquery_torch.tools.flow_bench import timeit

    h, w = hw
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (h + 2 * frames, w + 2 * frames, 3)).astype(np.float32)
    for ax in (0, 1):
        base = (np.roll(base, 1, ax) + base + np.roll(base, -1, ax)) / 3.0
    clip = np.stack([base[i:i + h, 2 * i:2 * i + w] for i in range(frames)]).astype(np.uint8)
    batch = torch.from_numpy(np.repeat(clip[None], batch_clips, axis=0)).to(device)
    cfg = ExtractionConfig(num_ticks=num_ticks, frame_resize=tuple(resize), crop_size=crop)
    tsn = TwoStreamTSN.random(0, tuple(splits), device)
    plan = step_plan(frames, cfg, "pallas", device)
    sec, _ = timeit(extract_step, tsn, batch, plan, cfg, True, PRODUCTION_TVL1, dtype,
                    reps=reps)
    return batch_clips / sec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--ticks", type=int, nargs="+", default=[25, 15, 10, 5])
    ap.add_argument("--frames", type=int, default=150,
                    help="clip length (150 = production 10 s at 15 fps)")
    ap.add_argument("--size", type=int, nargs=2, default=[128, 176], metavar=("H", "W"),
                    help="corpus frame size at scale 1 (flow_quality's)")
    ap.add_argument("--resize", type=int, nargs=2, default=[340, 256], metavar=("W", "H"))
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--no_bench", action="store_true", help="skip the clips/s batches")
    ap.add_argument("--batch_clips", type=int, default=8)
    ap.add_argument("--bench_hw", type=int, nargs=2, default=[256, 340], metavar=("H", "W"))
    ap.add_argument("--bench_splits", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--bench_reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, or VIDEOQUERY_DEVICE)")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Retrieval at each tick count and seed, then clips/s at each tick
    count; print the curve; return it."""
    with full_f32():
        return _run(parse_args(argv))


def _run(args) -> dict:
    from videoquery_torch.core.device import resolve_device
    from videoquery_torch.nn.tsn import TwoStreamTSN
    from videoquery_torch.tools.flow_quality import make_corpus, partner_accuracy

    device = resolve_device(args.device)
    tsn = TwoStreamTSN.random(0, (1,), device)
    acc = {t: [] for t in args.ticks}
    acc_rgb = {t: [] for t in args.ticks}
    for seed in args.seeds:
        clips, labels = make_corpus(frames=args.frames, h=args.size[0], w=args.size[1],
                                    seed=seed, scale=args.scale)
        for t in args.ticks:
            t0 = time.time()
            rgb, flow = embeddings_for_ticks(clips, t, tsn, device, args.resize, args.crop)
            acc[t].append(partner_accuracy(flow, labels))
            acc_rgb[t].append(partner_accuracy(rgb, labels))
            print(f"[{time.time() - t0:6.1f}s] seed {seed} ticks={t:2d}  flow retrieval "
                  f"{acc[t][-1]:.2f}  rgb {acc_rgb[t][-1]:.2f}", flush=True)
    rates = {}
    if not args.no_bench:
        for t in args.ticks:
            rates[t] = bench_batches(t, device, args.batch_clips, args.frames,
                                     tuple(args.bench_hw), tuple(args.bench_splits),
                                     resize=args.resize, crop=args.crop,
                                     reps=args.bench_reps)
    print(f"\n== tick-budget curve (mean over seeds {args.seeds}, scale {args.scale}, "
          f"{args.frames}-frame clips) ==")
    print(f"{'ticks':>5} {'flow-retr':>9} {'rgb-retr':>8} {'clips/s':>8}")
    rows = []
    for t in args.ticks:
        r = f"{rates[t]:8.2f}" if t in rates else "       -"
        print(f"{t:5d} {np.mean(acc[t]):9.3f} {np.mean(acc_rgb[t]):8.3f} {r}"
              f"   (per-seed {['%.2f' % a for a in acc[t]]})", flush=True)
        rows.append({"ticks": t, "flow_retrieval": float(np.mean(acc[t])),
                     "rgb_retrieval": float(np.mean(acc_rgb[t])),
                     "clips_per_s": rates.get(t)})
    return {"device": str(device), "seeds": args.seeds, "rows": rows}


def main(argv=None) -> None:
    print(json.dumps({"tick_sweep": run(argv)}), flush=True)


if __name__ == "__main__":
    main()
