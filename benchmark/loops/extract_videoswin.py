"""Video Swin extraction batches, rgb only, 12 views a segment, queued, in
a closed loop.

The traffic: batches of ``batch_clips`` segments x ``frames_per_clip``
textured camera-pan frames (``benchmark/frames.py``, the pan's and the
object's speeds from the mix) at the configuration's frame size, made as
``loops/extract.py`` makes them; the pool holds ``pool_batches`` distinct
batches, run in turn. Their payloads are built in set-up by
``pipeline/payload.build_payload`` with ``ExtractionConfig(arch=
"videoswin")``: the distinct frames of the ``num_clips`` clips of
``clip_len`` frames ``frame_interval`` apart that mmaction2's test-mode
``SampleFrames`` samples from each segment, and nothing else.

The window drives ``Extractor._dispatch_payload`` on an ``Extractor`` of
that configuration in its dtype: one pinned non-blocking upload of the
sampled frames, then ``extract_step``'s rgb-only path (the views gathered
on the card, the short-side resize, ``ThreeCrop``'s three crops and the
ImageNet normalisation, and one Video Swin member over the batch's
segments x 12 views, each 16 x 56 x 56 tokens, in one forward; each
segment's signature the mean of its views' features). No flow runs and
nothing in the step waits for the card; the program waits for the batch
before last before it queues the next. The window ends with one
synchronise.

The weights are drawn on the card (``reference/videoswin.make_weights``)
and copied into the program's network; the reference reads the same
tensors. The check recomputes each pool batch's signatures from its frames
with the plain reference in float32, one segment at a time (its own
sampling, resize, crops and normalisation: ``reference/videoswin.views``),
and compares the last signatures the window produced for it: mean
|program - reference| / mean |reference|, as ``loops/extract.py`` does.

    python3 -m benchmark.loops.extract_videoswin --seeds <n> ... [--control_seeds <n> ...]

prints, a seed a line, the program's reading and, for the control seeds,
the control's (the reference with per-tensor scaled float8 e4m3 operands
on every matrix product, ``benchmark/control.py::fp8``): the readings the
cell's limit is set from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import flops_videoswin
from benchmark.loops import extract as tsn_loop
from benchmark.reference import videoswin as ref_net

# the CPU tests' tiny sizes (registered by benchmark/tests/test_bench_videoswin.py)
SMALL_CONFIG = {"frame_hw": [64, 88], "fps": 4, "clip_seconds": 4, "frames_per_clip": 16,
                "frame_resize": [88, 64], "crop_size": 32, "short_side": 32, "batch_clips": 1,
                "clip_len": 4, "frame_interval": 2, "num_clips": 2, "embed_dim": 32,
                "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8], "window_size": [2, 3, 3]}
SMALL_TRAFFIC = {"pool_batches": 1, "warm_batches": 1}


def extraction_config(config: dict):
    from videoquery_torch.core.config import ExtractionConfig

    if config["num_crops"] != 3 or config["short_side"] != config["crop_size"]:
        raise ValueError("the program's views are ThreeCrop's of a short side equal to "
                         "the crop")
    cfg = ExtractionConfig(arch="videoswin", fps=config["fps"],
                           clip_seconds=config["clip_seconds"],
                           frame_resize=tuple(config["frame_resize"]),
                           crop_size=config["crop_size"], batch_clips=config["batch_clips"],
                           view_clip_len=config["clip_len"],
                           view_frame_interval=config["frame_interval"],
                           view_clips=config["num_clips"])
    if cfg.frames_per_clip != config["frames_per_clip"]:
        raise ValueError(f"{cfg.frames_per_clip} frames a segment, the configuration "
                         f"says {config['frames_per_clip']}")
    return cfg


def make_weights(config: dict, seed: int, device) -> dict:
    """The rgb member's weights, drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    return ref_net.make_weights(g, config, device)


def program_net(weights: dict, config: dict, device):
    """The program's Video Swin holding its own copy of the weights."""
    from videoquery_torch.nn.video_swin import VideoSwin

    tree = {layer: {k: v.clone() for k, v in leaf.items()} for layer, leaf in weights.items()}
    return VideoSwin(tree, window=config["window_size"]).to(device)


class Cell(tsn_loop.Cell):
    """The TSN cell's window and frames, with Video Swin's payloads,
    network, work and check."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, stages):
        # the program's Video Swin first: a program without it fails here, at once
        from videoquery_torch.nn.video_swin import VideoSwin  # noqa: F401
        from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN
        from videoquery_torch.pipeline.extract import Extractor
        from videoquery_torch.pipeline.payload import build_payload, plan_groups

        self.config, self.traffic, self.stage = config, traffic, stages
        self.device = torch.device(device)
        self.cfg = extraction_config(config)
        self.frames = tsn_loop.make_frames(config, traffic, seed)
        self.payloads = []
        for batch in self.frames:
            video = batch.reshape((-1,) + batch.shape[2:])
            [(group, nums)] = plan_groups(len(video), self.cfg)
            self.payloads.append(build_payload(video, None, group, nums, self.cfg,
                                               self.cfg.flow_res_div))
        self.weights = make_weights(config, seed, self.device)
        tsn = TwoStreamTSN(StreamEnsemble([program_net(self.weights, config, self.device)],
                                          (1,), 3), None)
        self.extractor = Extractor(tsn, self.cfg, device=self.device, dtype=config["dtype"])
        self.kept: dict[int, tuple] = {}
        self.attempted = self.failed = 0
        self.batches = 0
        self.window_s = 0.0

    def work(self) -> dict:
        return {"batches": self.batches,
                "batch_flops": flops_videoswin.batch_flops(self.config)}

    def check(self, limits: dict) -> dict:
        if not self.kept:
            raise RuntimeError("no batch completed in the window")
        err = 0.0
        for i, (rgb, _flow) in sorted(self.kept.items()):
            want = reference_signatures(self, i)
            err = max(err, float((rgb[0].float() - want).abs().mean() / want.abs().mean()))
        return {"rgb_rel_err": {"value": err, "limit": limits["rgb_rel_err"]}}


def reference_signatures(cell: Cell, i: int, cast=None) -> torch.Tensor:
    """f32 [B, D] of pool batch i by the reference (in float32, or with
    ``cast`` on every matrix product's operands, the control), one segment
    (its views) at a time."""
    frames_u8 = torch.from_numpy(cell.frames[i]).to(cell.device)
    window = cell.config["window_size"]
    out = [ref_net.embed(cell.weights, ref_net.views(segment, cell.config), window,
                         cast).mean(0) for segment in frames_u8]
    return torch.stack(out)


def control_readings(cell: Cell) -> dict:
    """The control's number under the cell's check: the reference in
    per-tensor scaled float8 e4m3 against the reference in float32."""
    from benchmark.control import fp8

    err = 0.0
    for i in sorted(cell.kept):
        want = reference_signatures(cell, i)
        got = reference_signatures(cell, i, cast=fp8)
        err = max(err, float((got - want).abs().mean() / want.abs().mean()))
    return {"rgb_rel_err": err}


def main(argv=None) -> int:
    from benchmark import registry, run as bench_run
    from benchmark.trace import Stages

    p = argparse.ArgumentParser(description="The Video Swin cell's readings: the program's "
                                            "and the float8 control's")
    p.add_argument("--workload", default="extract_videoswin_textured")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    bench_run.set_caches()
    if not torch.cuda.is_available():
        print("[extract_videoswin] needs a CUDA device", file=sys.stderr)
        return 2
    spec = registry.load_spec()
    entry = registry.find_cell(spec, args.workload)
    config = registry.load_config(spec, entry["config"])
    traffic = registry.load_traffic(entry["traffic"])
    device = torch.device("cuda:0")
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = Cell(config, traffic, seed, device, Stages(False))
        cell.warm()
        cell.run(args.seconds)
        torch.cuda.synchronize(device)
        cell.release()
        line = {"seed": seed, "program": {k: v["value"] for k, v in
                                          cell.check(traffic["limits"]).items()}}
        if seed in args.control_seeds:
            line["control"] = control_readings(cell)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
