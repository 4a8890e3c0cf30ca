"""Temporal Segment Networks: the two-stream ensemble over BN-Inception,
or over I3D; or one rgb stream of TimeSformer or of Video Swin.

Port of ``videoquery/nn/tsn.py``. A clip is scored by 6 CNNs: 2 streams
(rgb, warped optical flow) x 3 UCF101 splits, each applied to the clip's
ticks and averaged over them (calcSig_wOF.py:59-113). Here each stream holds
one ``BNInception`` per split and runs them in turn on the same batch. The
same ensembles hold I3D members (``nn/i3d.py``, one a stream: split 1),
each applied once to the clip's whole volume; a member's ``temporal`` says
which input it takes, and each constructor builds the member its
parameters describe. TimeSformer (``nn/timesformer.py``) is rgb only: its
``TwoStreamTSN`` holds no flow stream (``flow`` is None), and its one
member embeds the volume of a clip's sampled frames in 768 dimensions.
Video Swin (``nn/video_swin.py``) is rgb only too: its member embeds each
of a clip's views in 1,024 dimensions.

Weights cross from the JAX package with ``from_jax_params`` (per-split
pytrees of numpy arrays, HWIO convs) or from ``convert_caffe`` npz bundles
(written by either package's converter) with ``from_npz_dir``. Every constructor builds on
``resolve_device(device)``: the card unless the caller (or
``VIDEOQUERY_DEVICE``) names the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping

import numpy as np
import torch

from videoquery_torch.core.device import resolve_device
from videoquery_torch.nn import bn_inception, i3d, timesformer, video_swin
from videoquery_torch.nn.bn_inception import BNInception
from videoquery_torch.nn.convert_caffe import load_npz
from videoquery_torch.nn.i3d import InceptionI3d
from videoquery_torch.nn.timesformer import TimeSformer
from videoquery_torch.nn.video_swin import VideoSwin

# architecture -> (init_params, rgb channels, flow channels; None: rgb only)
ARCHS = {
    "bn_inception": (bn_inception.init_params, bn_inception.RGB_CHANNELS,
                     bn_inception.FLOW_CHANNELS),
    "i3d": (i3d.init_params, i3d.RGB_CHANNELS, i3d.FLOW_CHANNELS),
    "timesformer": (timesformer.make_weights, timesformer.RGB_CHANNELS, None),
    "videoswin": (video_swin.make_weights, video_swin.RGB_CHANNELS, None),
}

# member class -> architecture
_MEMBER_ARCHS = {BNInception: "bn_inception", InceptionI3d: "i3d", TimeSformer: "timesformer",
                 VideoSwin: "videoswin"}


def _member(tree: Mapping) -> "BNInception | InceptionI3d | TimeSformer | VideoSwin":
    """The network a parameter tree describes: I3D's, TimeSformer's or
    Video Swin's layer names, else BN-Inception's."""
    if i3d.STEM_CONV in tree:
        return InceptionI3d(tree)
    if video_swin.PATCH_EMBED in tree:
        return VideoSwin(tree)
    return TimeSformer(tree) if timesformer.EMBED in tree else BNInception(tree)


@dataclasses.dataclass
class StreamEnsemble:
    """One stream's K-split ensemble of BN-Inception, I3D, TimeSformer or
    Video Swin members."""

    nets: "list[BNInception | InceptionI3d | TimeSformer | VideoSwin]"
    splits: tuple[int, ...]
    in_channels: int

    @property
    def temporal(self) -> bool:
        """Whether the members embed a clip's volume [N, T, H, W, C] (I3D,
        TimeSformer, Video Swin) rather than images [N, H, W, C]
        (BN-Inception, a tick each)."""
        return self.nets[0].temporal

    @property
    def arch(self) -> str:
        """The members' architecture (``ARCHS``'s name)."""
        return _MEMBER_ARCHS[type(self.nets[0])]

    @staticmethod
    def from_jax_params(split_params: Mapping[int, Mapping], in_channels: int,
                        device=None) -> "StreamEnsemble":
        """Per-split parameter trees in the JAX package's layout ({layer:
        {'w': HWIO, 'b'}} of numpy or JAX arrays) -> the port's modules
        (OIHW) on ``resolve_device(device)``."""
        device = resolve_device(device)
        splits = tuple(sorted(split_params))
        nets = []
        for s in splits:
            tree = {layer: {k: np.asarray(a, np.float32) for k, a in leaf.items()}
                    for layer, leaf in split_params[s].items()}
            nets.append(_member(tree).to(device))
        return StreamEnsemble(nets, splits, in_channels)

    @staticmethod
    def random(seed: int, in_channels: int, splits=(1, 2, 3),
               device=None, arch: str = "bn_inception") -> "StreamEnsemble":
        """Random weights; split s of the stream is the architecture's
        init_params(seed + s)."""
        init = ARCHS[arch][0]
        return StreamEnsemble.from_jax_params(
            {s: init(seed + s, in_channels) for s in splits},
            in_channels, device)

    def shard(self, model_rank: int, model_size: int) -> "StreamEnsemble":
        """The splits of model shard ``model_rank`` of ``model_size``: a
        contiguous run of K / model_size splits in split order (the JAX
        package's P("model") of the stacked parameters). The nets are the
        same modules, not copies, so their bf16 weight and T1 block caches
        stay theirs. ValueError unless model_size divides K."""
        k = len(self.nets)
        if model_size < 1 or k % model_size:
            raise ValueError(f"a model axis of {model_size} does not divide the "
                             f"{k} splits of the ensemble")
        if not 0 <= model_rank < model_size:
            raise ValueError(f"model rank {model_rank} outside a model axis of {model_size}")
        per = k // model_size
        lo = model_rank * per
        return StreamEnsemble(self.nets[lo:lo + per], self.splits[lo:lo + per],
                              self.in_channels)

    @torch.no_grad()
    def embed(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, ..., C] -> [K, N, D]: images [N, H, W, C] for BN-Inception
        members, volumes [N, T, H, W, C] for I3D's, TimeSformer's and Video
        Swin's (``temporal``); D is the architecture's width (1024,
        TimeSformer 768)."""
        return torch.stack([net.embed(frames) for net in self.nets])


@dataclasses.dataclass
class TwoStreamTSN:
    """The full 6-member signature model, or TimeSformer's or Video Swin's
    rgb stream alone (``flow`` None)."""

    rgb: StreamEnsemble
    flow: StreamEnsemble | None

    @staticmethod
    def random(seed: int = 0, splits=(1, 2, 3), device=None,
               arch: str = "bn_inception") -> "TwoStreamTSN":
        """Seeded random weights (rgb split s: seed + s; flow split s:
        seed + 100 + s) of the architecture's members: BN-Inception (flow
        stacks of 10 channels), I3D (flow (u, v), 2 channels), TimeSformer
        or Video Swin (no flow stream)."""
        _init, rgb_channels, flow_channels = ARCHS[arch]
        return TwoStreamTSN(
            StreamEnsemble.random(seed, rgb_channels, splits, device, arch),
            None if flow_channels is None else
            StreamEnsemble.random(seed + 100, flow_channels, splits, device, arch))

    @staticmethod
    def from_jax_params(rgb: Mapping[int, Mapping], flow: Mapping[int, Mapping],
                        device=None) -> "TwoStreamTSN":
        return TwoStreamTSN(
            StreamEnsemble.from_jax_params(rgb, bn_inception.RGB_CHANNELS, device),
            StreamEnsemble.from_jax_params(flow, bn_inception.FLOW_CHANNELS, device))

    @staticmethod
    def from_npz_dir(weights_dir: str, splits=(1, 2, 3),
                     device=None) -> "TwoStreamTSN":
        """convert_caffe bundles <dir>/{rgb,flow}_split<s>.npz."""
        return TwoStreamTSN.from_jax_params(
            {s: load_npz(os.path.join(weights_dir, f"rgb_split{s}.npz")) for s in splits},
            {s: load_npz(os.path.join(weights_dir, f"flow_split{s}.npz")) for s in splits},
            device)

    @torch.no_grad()
    def clip_signature(self, rgb_ticks: torch.Tensor,
                       flow_stacks: torch.Tensor) -> dict[str, torch.Tensor]:
        """rgb_ticks [B, T, H, W, 3], flow_stacks [B, T, H, W, 10] ->
        {'rgb': [K, B, 1024], 'warped_optical_flow': [K, B, 1024]}, the
        per-(split, clip) embeddings averaged over the T ticks."""
        b, t = rgb_ticks.shape[:2]
        rgb = self.rgb.embed(rgb_ticks.reshape((b * t,) + rgb_ticks.shape[2:]))
        flow = self.flow.embed(flow_stacks.reshape((b * t,) + flow_stacks.shape[2:]))
        k = rgb.shape[0]
        return {"rgb": rgb.reshape(k, b, t, -1).mean(dim=2),
                "warped_optical_flow": flow.reshape(k, b, t, -1).mean(dim=2)}
