"""Temporal Segment Networks: the two-stream ensemble over BN-Inception.

Port of ``videoquery/nn/tsn.py``. A clip is scored by 6 CNNs: 2 streams
(rgb, warped optical flow) x 3 UCF101 splits, each applied to the clip's
ticks and averaged over them (calcSig_wOF.py:59-113). Here each stream holds
one ``BNInception`` per split and runs them in turn on the same batch.

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
from videoquery_torch.nn.bn_inception import (FLOW_CHANNELS, RGB_CHANNELS,
                                              BNInception, init_params)
from videoquery_torch.nn.convert_caffe import load_npz


@dataclasses.dataclass
class StreamEnsemble:
    """One stream's K-split ensemble."""

    nets: list[BNInception]
    splits: tuple[int, ...]
    in_channels: int

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
            nets.append(BNInception(tree).to(device))
        return StreamEnsemble(nets, splits, in_channels)

    @staticmethod
    def random(seed: int, in_channels: int, splits=(1, 2, 3),
               device=None) -> "StreamEnsemble":
        """Random weights; split s of the stream is init_params(seed + s)."""
        return StreamEnsemble.from_jax_params(
            {s: init_params(seed + s, in_channels) for s in splits},
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
        """NHWC [B, H, W, C] -> [K, B, 1024]."""
        return torch.stack([net.embed(frames) for net in self.nets])


@dataclasses.dataclass
class TwoStreamTSN:
    """The full 6-member signature model."""

    rgb: StreamEnsemble
    flow: StreamEnsemble

    @staticmethod
    def random(seed: int = 0, splits=(1, 2, 3), device=None) -> "TwoStreamTSN":
        """Seeded random weights (rgb split s: seed + s; flow split s:
        seed + 100 + s)."""
        return TwoStreamTSN(
            StreamEnsemble.random(seed, RGB_CHANNELS, splits, device),
            StreamEnsemble.random(seed + 100, FLOW_CHANNELS, splits, device))

    @staticmethod
    def from_jax_params(rgb: Mapping[int, Mapping], flow: Mapping[int, Mapping],
                        device=None) -> "TwoStreamTSN":
        return TwoStreamTSN(
            StreamEnsemble.from_jax_params(rgb, RGB_CHANNELS, device),
            StreamEnsemble.from_jax_params(flow, FLOW_CHANNELS, device))

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
