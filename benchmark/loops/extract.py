"""Two-stream extraction batches, queued, in a closed loop.

The traffic: batches of ``batch_clips`` clips x ``frames_per_clip``
textured camera-pan frames (``benchmark/frames.py``, the pan's and the
object's speeds from the mix) at the configuration's frame size. The pool
holds ``pool_batches`` distinct batches, run in turn. Their payloads are
built in set-up by ``pipeline/payload.build_payload`` with the
configuration's ``ExtractionConfig`` (full frames, gray on the card), as
the decode workers build them.

The window drives the program's device half of a batch,
``Extractor._dispatch_payload`` on an ``Extractor`` of the configuration's
dtype: one pinned non-blocking upload, then ``extract_step`` (gray, the
warped TV-L1 of the selected pairs on K3 and K2 with the warm plan, the
fast-motion rescue, the preprocess and 2 streams x K splits of
BN-Inception). Batches are queued as the program allows (it waits for the
card once a batch, for the rescue's choice); the window ends with one
synchronise, and every batch dispatched in it is complete by then.

The weights are drawn on the card (``reference/bninception.make_weights``)
and copied into the program's networks; the reference reads the same
tensors. The check recomputes each pool batch's signatures from its frames
with the plain reference in float32 (``reference/tvl1/pairs.prepare`` and
``reference/bninception.embed``) and compares the last signatures the
window produced for it: per stream, mean |program - reference| / mean
|reference| (the JAX package's bf16 criterion's form).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import flops, frames
from benchmark.reference import bninception as ref_net
from benchmark.reference.tvl1 import pairs as ref_pairs

STREAMS = (("rgb", 3), ("warped_optical_flow", 10))


def extraction_config(config: dict):
    from videoquery_torch.core.config import ExtractionConfig

    cfg = ExtractionConfig(fps=config["fps"], clip_seconds=config["clip_seconds"],
                           num_ticks=config["num_ticks"],
                           flow_stack_depth=config["flow_stack_depth"],
                           frame_resize=tuple(config["frame_resize"]),
                           crop_size=config["crop_size"], flow_bound=config["flow_bound"],
                           batch_clips=config["batch_clips"])
    if cfg.frames_per_clip != config["frames_per_clip"]:
        raise ValueError(f"{cfg.frames_per_clip} frames a clip, the configuration "
                         f"says {config['frames_per_clip']}")
    return cfg


def make_frames(config: dict, traffic: dict, seed: int) -> list[np.ndarray]:
    """The pool's batches, u8 [B, F, H, W, 3] each."""
    rng = np.random.default_rng(seed)
    h, w = config["frame_hw"]
    return [frames.textured_motion_frames(config["batch_clips"], config["frames_per_clip"],
                                          h, w, rng, traffic["pan_speed"],
                                          traffic["object_speed"])
            for _ in range(traffic["pool_batches"])]


def make_weights(config: dict, seed: int, device) -> dict:
    """{stream: [member weights of each split]}, drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {stream: [ref_net.make_weights(g, ch, device) for _ in config["splits"]]
            for stream, ch in STREAMS}


def program_tsn(weights: dict, config: dict, device):
    """The program's TwoStreamTSN holding the benchmark's weights."""
    from videoquery_torch.nn.bn_inception import BNInception
    from videoquery_torch.nn.tsn import StreamEnsemble, TwoStreamTSN

    ensembles = []
    for stream, ch in STREAMS:
        nets = []
        for member in weights[stream]:
            tree = {name: {"w": np.zeros((w.shape[2], w.shape[3], w.shape[1], w.shape[0]),
                                         np.float32),
                           "b": np.zeros(w.shape[0], np.float32)}
                    for name, (w, _b) in member.items()}
            tree["fc-action"] = {"w": np.zeros((ref_net.EMBED_DIM, config["num_classes"]),
                                               np.float32),
                                 "b": np.zeros(config["num_classes"], np.float32)}
            net = BNInception(tree).to(device)
            with torch.no_grad():
                for name, (w, b) in member.items():
                    key = name.replace("/", "__")
                    net.weights[key].copy_(w)
                    net.biases[key].copy_(b)
            nets.append(net)
        ensembles.append(StreamEnsemble(nets, tuple(config["splits"]), ch))
    return TwoStreamTSN(*ensembles)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, stages):
        from videoquery_torch.pipeline.extract import Extractor
        from videoquery_torch.pipeline.payload import build_payload, plan_groups

        self.config, self.traffic, self.stage = config, traffic, stages
        self.device = torch.device(device)
        self.cfg = extraction_config(config)
        self.frames = make_frames(config, traffic, seed)
        self.payloads = []
        for batch in self.frames:
            video = batch.reshape((-1,) + batch.shape[2:])
            [(group, nums)] = plan_groups(len(video), self.cfg)
            self.payloads.append(build_payload(video, None, group, nums, self.cfg,
                                               self.cfg.flow_res_div))
        self.weights = make_weights(config, seed, self.device)
        self.extractor = Extractor(program_tsn(self.weights, config, self.device), self.cfg,
                                   device=self.device, dtype=config["dtype"])
        self.kept: dict[int, tuple] = {}
        self.attempted = self.failed = 0
        self.batches = 0
        self.window_s = 0.0

    def _dispatch(self, i: int):
        with self.stage("extract.batch", sync=False):
            return self.extractor._dispatch_payload(self.payloads[i])

    def warm(self) -> None:
        for i in range(min(self.traffic["warm_batches"], len(self.payloads))):
            self._dispatch(i)

    def run(self, seconds: float) -> None:
        start = time.perf_counter()
        end = start + seconds
        n = 0
        last = {}
        while time.perf_counter() < end:
            i = n % len(self.payloads)
            self.attempted += 1
            try:
                last[i] = self._dispatch(i)
            except Exception as exc:
                self.failed += 1
                print(f"[extract] batch {i} failed: {exc!r}", file=sys.stderr)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - start
        self.batches = n - self.failed
        self.kept = {i: (s.rgb, s.flow) for i, s in last.items()}

    def end_to_end(self) -> dict:
        return {"extract_clips_per_s": self.batches * self.config["batch_clips"]
                / self.window_s}

    def work(self) -> dict:
        c = self.config
        return {"batches": self.batches,
                "batch_flops": flops.batch_flops(len(c["splits"]), c["batch_clips"],
                                                 c["num_ticks"])}

    def release(self) -> None:
        self.extractor = None

    def check(self, limits: dict) -> dict:
        if not self.kept:
            raise RuntimeError("no batch completed in the window")
        r = {"rgb_rel_err": 0.0, "flow_rel_err": 0.0}
        for i, (rgb, flow) in sorted(self.kept.items()):
            want = reference_signatures(self, i)
            for name, got in (("rgb_rel_err", rgb), ("flow_rel_err", flow)):
                ref = want[name.split("_")[0]]
                err = float((got.float() - ref).abs().mean() / ref.abs().mean())
                r[name] = max(r[name], err)
        return {k: {"value": v, "limit": limits[k]} for k, v in r.items()}


def reference_signatures(cell: Cell, i: int, cast=None, gray_operands=None) -> dict:
    """{"rgb", "flow"}: f32 [K, B, 1024] of pool batch i by the reference
    (in float32, or with ``cast`` on the networks' operands and
    ``gray_operands`` on the gray's, the control)."""
    from benchmark.reference.tvl1.pairs import PRODUCTION_TVL1

    frames_u8 = torch.from_numpy(cell.frames[i]).to(cell.device)
    kw = {} if gray_operands is None else {"gray_operands": gray_operands}
    rgb_in, flow_in, _ = ref_pairs.prepare(frames_u8, cell.cfg, PRODUCTION_TVL1, **kw)
    del frames_u8
    out = {}
    for key, (stream, _ch), x in (("rgb", STREAMS[0], rgb_in), ("flow", STREAMS[1], flow_in)):
        b, t = x.shape[:2]
        flat = x.reshape((b * t,) + x.shape[2:])
        out[key] = torch.stack([ref_net.embed(m, flat, cast).reshape(b, t, -1).mean(dim=1)
                                for m in cell.weights[stream]])
    return out
