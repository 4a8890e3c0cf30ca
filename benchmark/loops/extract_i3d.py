"""Two-stream I3D extraction batches, queued, in a closed loop.

The traffic: batches of ``batch_clips`` segments x ``frames_per_clip``
textured camera-pan frames (``benchmark/frames.py``, the pan's and the
object's speeds from the mix) at the configuration's frame size, made and
built into payloads (``pipeline/payload.build_payload``, full frames, gray
on the card) as ``loops/extract.py`` makes them; the pool holds
``pool_batches`` distinct batches, run in turn.

The window drives ``Extractor._dispatch_payload`` on an ``Extractor`` of
``ExtractionConfig(arch="i3d")`` in the configuration's dtype: one pinned
non-blocking upload, then ``extract_step`` on the dense plan (gray at the
flow grid, the plain TV-L1 of every consecutive pair on K2 with the warm
plan, the fast-motion rescue, the rgb volume of every frame and the scaled
flow volume) and one I3D member a stream over each segment's whole volume.
Batches are queued as the program allows (it waits for the card once a
batch, for the rescue's choice); the window ends with one synchronise.

The weights are drawn on the card (``reference/i3d.make_weights``) and
copied into the program's networks; the reference reads the same tensors.
The check recomputes each pool batch's signatures from its frames with the
plain reference in float32, one segment at a time (``reference_inputs``:
``reference/tvl1/pairs``'s unwarped ``_solve_pairs`` and rescue on the
dense pairs; ``reference/i3d.embed``), and compares the last signatures
the window produced for it: per stream, mean |program - reference| / mean
|reference|, as ``loops/extract.py`` does.

    python3 -m benchmark.loops.extract_i3d --seeds <n> ... [--control_seeds <n> ...]

prints, a seed a line, the program's readings and, for the control seeds,
the control's (the reference with per-tensor scaled float8 e4m3 conv and
gray operands, ``benchmark/control.py::fp8``): the readings the cell's
limits are set from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import flops_i3d
from benchmark.loops import extract as tsn_loop
from benchmark.reference import i3d as ref_net
from benchmark.reference.tvl1 import pairs as ref_pairs
from benchmark.reference.tvl1.preprocess import _resize_crop
from benchmark.reference.tvl1.sampling import flow_warm_plan

STREAMS = (("rgb", 3), ("flow", 2))

# the CPU tests' tiny sizes (registered by benchmark/tests/conftest.py)
SMALL_CONFIG = {"frame_hw": [64, 88], "fps": 4, "clip_seconds": 4, "frames_per_clip": 16,
                "frame_resize": [88, 64], "crop_size": 64, "batch_clips": 1}
SMALL_TRAFFIC = {"pool_batches": 1, "warm_batches": 1}


def extraction_config(config: dict):
    from videoquery_torch.core.config import ExtractionConfig

    cfg = ExtractionConfig(arch="i3d", fps=config["fps"], clip_seconds=config["clip_seconds"],
                           frame_resize=tuple(config["frame_resize"]),
                           crop_size=config["crop_size"], flow_bound=config["flow_bound"],
                           batch_clips=config["batch_clips"])
    if cfg.frames_per_clip != config["frames_per_clip"]:
        raise ValueError(f"{cfg.frames_per_clip} frames a segment, the configuration "
                         f"says {config['frames_per_clip']}")
    return cfg


def make_weights(seed: int, device) -> dict:
    """{stream: member weights}, drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {stream: ref_net.make_weights(g, ch, device) for stream, ch in STREAMS}


def program_net(member: dict, config: dict, device):
    """The program's InceptionI3d holding one member's weights."""
    from videoquery_torch.nn.i3d import LOGITS, InceptionI3d

    tree = {name: {"w": np.zeros(tuple(w.shape[2:]) + (w.shape[1], w.shape[0]), np.float32),
                   "b": np.zeros(w.shape[0], np.float32)}
            for name, (w, _b) in member.items()}
    tree[LOGITS] = {"w": np.zeros((ref_net.EMBED_DIM, config["num_classes"]), np.float32),
                    "b": np.zeros(config["num_classes"], np.float32)}
    net = InceptionI3d(tree).to(device)
    with torch.no_grad():
        for name, (w, b) in member.items():
            key = name.replace("/", "__")
            net.weights[key].copy_(w)
            net.biases[key].copy_(b)
    return net


class Cell(tsn_loop.Cell):
    """The TSN cell's window, payloads and frames, with I3D's networks,
    work and check."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, stages):
        # the program's I3D first: a program without it fails here, at once
        from videoquery_torch.nn.i3d import InceptionI3d  # noqa: F401
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
        self.weights = make_weights(seed, self.device)
        tsn = TwoStreamTSN(*[StreamEnsemble([program_net(self.weights[s], config, self.device)],
                                            (1,), ch) for s, ch in STREAMS])
        self.extractor = Extractor(tsn, self.cfg, device=self.device, dtype=config["dtype"])
        self.kept: dict[int, tuple] = {}
        self.attempted = self.failed = 0
        self.batches = 0
        self.window_s = 0.0

    def work(self) -> dict:
        c = self.config
        return {"batches": self.batches,
                "batch_flops": flops_i3d.batch_flops(c["batch_clips"], c["frames_per_clip"],
                                                     c["crop_size"])}

    def check(self, limits: dict) -> dict:
        if not self.kept:
            raise RuntimeError("no batch completed in the window")
        r = {"rgb_rel_err": 0.0, "flow_rel_err": 0.0}
        for i, (rgb, flow) in sorted(self.kept.items()):
            want = reference_signatures(self, i)
            for name, got in (("rgb_rel_err", rgb), ("flow_rel_err", flow)):
                ref = want[name.split("_")[0]]
                err = float((got[0].float() - ref).abs().mean() / ref.abs().mean())
                r[name] = max(r[name], err)
        return {k: {"value": v, "limit": limits[k]} for k, v in r.items()}


@torch.no_grad()
def reference_inputs(frames_u8: torch.Tensor, cfg, gray_operands=lambda x: x):
    """frames u8 [B, F, H, W, 3] BGR -> I3D's inputs, f32: rgb [B, F, crop,
    crop, 3] (RGB, x / 127.5 - 1) and flow [B, F - 1, crop, crop, 2] (every
    consecutive pair's plain TV-L1 with the warm plan and the rescue, in
    native pixels, truncated to the bound and divided by it, resized and
    cropped)."""
    tvl1 = ref_pairs.PRODUCTION_TVL1
    b, f = frames_u8.shape[:2]
    pair_idx = np.arange(f - 1, dtype=np.int64)
    key_pos, warm_pos, warm_src = flow_warm_plan(pair_idx, cfg.flow_warm_group)
    warm = (tuple(torch.as_tensor(a.astype(np.int64), device=frames_u8.device)
                  for a in (key_pos, warm_pos, warm_src)) if warm_pos.size else None)
    gray, (sx, sy) = ref_pairs._flow_gray_grid(frames_u8, cfg.flow_res_div,
                                               cfg.flow_gray_matmul, gray_operands)
    i0, i1, u, v = ref_pairs._solve_pairs(gray, torch.as_tensor(pair_idx, device=gray.device),
                                          False, tvl1, warm, cfg.flow_warm_camera, 0)
    u, v = ref_pairs._rescue_fast_motion(i0, i1, u, v, False, tvl1)
    h, w = u.shape[1:]
    uv = torch.stack([u * sx, v * sy], dim=-1).reshape(b, f - 1, h, w, 2)
    uv = torch.clamp(uv, -cfg.flow_bound, cfg.flow_bound) / cfg.flow_bound
    flow = _resize_crop(uv, cfg.frame_resize[0], cfg.frame_resize[1], cfg.crop_size, "center")
    rgb = _resize_crop(frames_u8, cfg.frame_resize[0], cfg.frame_resize[1], cfg.crop_size,
                       "center")
    return rgb.flip(-1) / 127.5 - 1.0, flow


def reference_signatures(cell: Cell, i: int, cast=None, gray_operands=None) -> dict:
    """{"rgb", "flow"}: f32 [B, 1024] of pool batch i by the reference (in
    float32, or with ``cast`` on the networks' operands and
    ``gray_operands`` on the gray's, the control), one segment at a time."""
    frames_u8 = torch.from_numpy(cell.frames[i]).to(cell.device)
    kw = {} if gray_operands is None else {"gray_operands": gray_operands}
    rgb_in, flow_in = reference_inputs(frames_u8, cell.cfg, **kw)
    del frames_u8
    out = {}
    for (stream, _ch), x in zip(STREAMS, (rgb_in, flow_in)):
        out[stream] = torch.cat([ref_net.embed(cell.weights[stream], x[j:j + 1], cast)
                                 for j in range(x.shape[0])])
    return out


def control_readings(cell: Cell) -> dict:
    """The control's numbers under the cell's check: the reference in
    per-tensor scaled float8 e4m3 against the reference in float32."""
    from benchmark.control import fp8

    r = {"rgb_rel_err": 0.0, "flow_rel_err": 0.0}
    for i in sorted(cell.kept):
        want = reference_signatures(cell, i)
        got = reference_signatures(cell, i, cast=fp8, gray_operands=fp8)
        for key in ("rgb", "flow"):
            err = float((got[key] - want[key]).abs().mean() / want[key].abs().mean())
            r[key + "_rel_err"] = max(r[key + "_rel_err"], err)
    return r


def main(argv=None) -> int:
    from benchmark import registry, run as bench_run
    from benchmark.trace import Stages

    p = argparse.ArgumentParser(description="The I3D cell's readings: the program's "
                                            "and the float8 control's")
    p.add_argument("--workload", default="extract_i3d_textured")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    bench_run.set_caches()
    if not torch.cuda.is_available():
        print("[extract_i3d] needs a CUDA device", file=sys.stderr)
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
