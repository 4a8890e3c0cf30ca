"""Unified typed configuration.

The reference scatters configuration across three mechanisms — env vars
(reference authenticate.py:10-13, broker.py:83-91, hyperparameter.py:5),
argparse CLIs (calcSig_wOF.py:156-177, build_wof_clips.py:133-150,
load_db.py:32-39) and module constants (broker.py:36-59). Here every knob
lives in one dataclass hierarchy; env vars override defaults, CLI flags
override env vars.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np

# Streams in the canonical order the reference uses (broker.py:42-45).
RGB = "rgb"
FLOW = "warped_optical_flow"
DEFAULT_STREAMS: tuple[str, ...] = (RGB, FLOW)

# Process states of the job state machine (compute_matches.py:43,49,104,107).
STATE_IN_PROGRESS = 3
STATE_PROCESSED = 4
STATE_ERROR = 5
STATE_FINALIZED = 7


def compute_eps(default: float = 1.0e-6) -> float:
    """Round-off buffer used by the threshold optimizer and finalize near-miss
    computation (reference hyperparameter.py:5,75 and compute_matches.py:84).

    The reference *requires* the COMPUTE_EPS env var; we default it so the
    library is importable standalone.
    """
    raw = os.environ.get("COMPUTE_EPS")
    return float(raw) if raw not in (None, "", "None") else default


def random_seed() -> int | str | None:
    """RANDOM_SEED env contract (reference broker.py:83-84, README.md:35-38):
    the literal string "None" (or unset) means unseeded."""
    raw = os.environ.get("RANDOM_SEED")
    if raw in (None, "", "None"):
        return None
    try:
        return int(raw)
    except ValueError:
        return raw  # CPython's random.seed accepts strings too.


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Search hyperparameters (reference broker.py:36-59, hyperparameter.py:9-27).

    Immutable — the optimizer returns a new instance instead of mutating
    (the reference mutates `Hyperparameter.weights/.threshold` in place at
    hyperparameter.py:75-76; a frozen dataclass makes round-to-round state
    explicit and jit-friendly).
    """

    default_weights: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {RGB: 1.0, FLOW: 1.5}
    )
    default_threshold: float = 0.8
    ballast: float = 0.0
    near_miss_default: float = 0.35
    mu: float = 0.0
    streams: tuple[str, ...] = DEFAULT_STREAMS
    feature_name: str = "global_pool"
    f_bootstrap: float = 1.0
    f_memory: float = 0.7
    bootstrap_type: str = "bagging"  # 'simple' | 'partial_update' | 'bagging'
    nbags: int = 3
    # Optimizer grids (reference hyperparameter.py:20-21).
    weight_grid_start: float = 0.5
    weight_grid_stop: float = 2.5
    weight_grid_step: float = 0.05
    threshold_grid_start: float = 0.5
    threshold_grid_stop: float = 1.1
    threshold_grid_step: float = 0.02

    # Mutable round state, carried functionally.
    weights: Mapping[str, float] | None = None
    threshold: float | None = None

    def __post_init__(self):
        if self.bootstrap_type not in ("simple", "partial_update", "bagging"):
            raise ValueError(
                "bootstrap_type must be one of 'simple', 'partial_update', "
                f"'bagging'; got {self.bootstrap_type!r}"
            )
        if not 0.0 < self.f_bootstrap <= 1.0:
            raise ValueError(f"f_bootstrap must be in (0, 1]; got {self.f_bootstrap}")
        if not 0.0 <= self.f_memory <= 1.0:
            raise ValueError(f"f_memory must be in [0, 1]; got {self.f_memory}")
        if not 0.0 <= self.ballast < 1.0:
            raise ValueError(f"ballast must be in [0, 1); got {self.ballast}")
        if self.weights is None:
            object.__setattr__(self, "weights", dict(self.default_weights))
        if self.threshold is None:
            object.__setattr__(self, "threshold", self.default_threshold)

    @property
    def weight_grid(self) -> np.ndarray:
        return np.arange(self.weight_grid_start, self.weight_grid_stop,
                         self.weight_grid_step)

    @property
    def threshold_grid(self) -> np.ndarray:
        return np.arange(self.threshold_grid_start, self.threshold_grid_stop,
                         self.threshold_grid_step)

    def weight_vector(self) -> np.ndarray:
        """Weights as an array in stream order."""
        return np.asarray([self.weights[s] for s in self.streams], np.float64)

    def with_round_state(self, weights: Mapping[str, float],
                         threshold: float) -> "HyperParams":
        return dataclasses.replace(self, weights=dict(weights), threshold=float(threshold))

    def reset_round_state(self) -> "HyperParams":
        return self.with_round_state(self.default_weights, self.default_threshold)


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Device-side search engine configuration."""

    feature_dim: int = 1024
    n_splits: int = 3
    similarity_dtype: str = "float32"  # accumulation is always f32
    # Pad the clip axis to a multiple of this (the broker's index build
    # uses 512).
    clip_pad_multiple: int = 512
    # Search sets at or above this many (padded) clips use the
    # device-resident round (engine.ResidentTable): the similarity table
    # never downloads wholesale — the optimizer gathers the reviewed rows
    # and selection fetches only the banded candidates. Below it, the
    # one-shot full-table download is used. The crossover was chosen for
    # the JAX package; it is not yet re-measured for the port.
    big_round_threshold: int = 50_000


EXTRACTION_ARCHS = ("bn_inception", "i3d", "timesformer", "videoswin")
# the architectures with an rgb stream alone: no gray, flow or rescue
RGB_ONLY_ARCHS = ("timesformer", "videoswin")
# each architecture's signature width (ExtractionConfig.feature_dim)
FEATURE_DIMS = {"bn_inception": 1024, "i3d": 1024, "timesformer": 768, "videoswin": 1024}


@dataclasses.dataclass(frozen=True)
class ExtractionConfig:
    """Two-stream extraction pipeline configuration (reference
    calcSig_wOF.py:156-189 and build_wof_clips.py:133-150). A copy of the
    JAX package's; the comments there say why each default was chosen."""

    fps: int = 15
    clip_seconds: int = 10
    num_ticks: int = 25          # frames scored per clip (calcSig_wOF.py:165)
    flow_stack_depth: int = 5    # flow stack (calcSig_wOF.py:185-189)
    frame_resize: tuple[int, int] = (340, 256)  # (W, H), calcSig_wOF.py:94
    crop_size: int = 224
    # the signature width: the architecture's (FEATURE_DIMS) when None
    feature_dim: int | None = None
    feature_blob: str = "global_pool"
    flow_bound: float = 20.0     # dense_flow -b 20 (build_wof_clips.py:70-73)
    min_tail_seconds: int = 2    # remainder clip kept iff >= 2 s (build_wof_clips.py:105)
    batch_clips: int = 8         # clips per device batch in the extractor
    # flow runs at frame_res/flow_res_div; flow values are rescaled to
    # native pixels before quantization
    flow_res_div: int = 2
    # temporal warm start: one keyframe pair per group solves the full
    # pyramid, the others refine its flow at the finest level (0/1: off)
    flow_warm_group: int = 3
    # camera of a warm pair: "init" refines the key's homography with 3 LK
    # iterations, "own" estimates it afresh, "key" reuses the key's
    flow_warm_camera: str = "init"
    # gray + flow-grid resize as two matmuls (bf16 operands on an
    # accelerator, f32 on the CPU)
    flow_gray_matmul: bool = True
    # decode straight to frame_resize (one cv2 resize at decode time)
    decode_at_target: bool = True
    # compact uploads: the uint8 gray at the flow grid computed on the host
    # and only the tick frames uploaded (host_gray); those frames resized and
    # cropped on the host (host_crop); and packed as YUV 4:2:0 (host_yuv420)
    host_gray: bool = False
    host_crop: bool = False
    host_yuv420: bool = False
    # streaming decode: the producer thread runs at most this many clip
    # batches ahead of the device (2 at least: one in flight, one decoding)
    stream_window_batches: int = 3
    # the networks: "bn_inception" (TSN: num_ticks rgb ticks and flow stacks
    # of flow_stack_depth pairs a clip), "i3d" (dense: every frame of the
    # clip as one rgb volume, every consecutive pair as one flow volume;
    # num_ticks and flow_stack_depth unused), "timesformer" (rgb only:
    # num_frames frames a clip by PySlowFast's linspace rule, one volume; no
    # flow) or "videoswin" (rgb only: mmaction2's test views, view_clips
    # volumes of view_clip_len frames x 3 crops a clip, their features
    # averaged; no flow)
    arch: str = "bn_inception"
    # frames a clip TimeSformer reads (its time embeddings' count)
    num_frames: int = 96
    # Video Swin's views of a clip: SampleFrames(clip_len=view_clip_len,
    # frame_interval=view_frame_interval, num_clips=view_clips,
    # test_mode=True), then Resize(scale=(-1, crop_size)) and
    # ThreeCrop(crop_size)
    view_clip_len: int = 32
    view_frame_interval: int = 2
    view_clips: int = 4

    def __post_init__(self):
        if self.arch not in EXTRACTION_ARCHS:
            raise ValueError(f"arch must be one of {EXTRACTION_ARCHS}; got {self.arch!r}")
        dim = FEATURE_DIMS[self.arch]
        if self.feature_dim is None:
            object.__setattr__(self, "feature_dim", dim)
        elif self.feature_dim != dim:
            raise ValueError(f"arch {self.arch!r} gives {dim}-d signatures; "
                             f"got feature_dim={self.feature_dim}")
        if self.arch == "i3d" and self.host_gray:
            raise ValueError("the compact uploads (host_gray) carry the tick frames "
                             "only; arch 'i3d' reads every frame")
        if self.rgb_only and (self.host_gray or self.host_crop):
            raise ValueError(f"arch {self.arch!r} uploads its sampled frames whole and "
                             "computes no flow: host_gray and host_crop do not apply")
        if self.flow_warm_camera not in ("key", "own", "init"):
            raise ValueError(
                f"flow_warm_camera must be 'key', 'own' or 'init'; "
                f"got {self.flow_warm_camera!r}")
        if self.host_crop and not self.host_gray:
            raise ValueError("host_crop requires host_gray=True "
                             "(it crops the compact tick-frame upload)")
        if self.host_yuv420:
            if not self.host_crop:
                raise ValueError("host_yuv420 requires host_crop=True "
                                 "(it packs the cropped tick frames)")
            if self.crop_size % 4:
                raise ValueError("host_yuv420 needs crop_size % 4 == 0 "
                                 "(I420 stores chroma rows pairwise)")

    @property
    def frames_per_clip(self) -> int:
        return self.fps * self.clip_seconds

    @property
    def rgb_only(self) -> bool:
        """Whether the networks have an rgb stream alone (RGB_ONLY_ARCHS)."""
        return self.arch in RGB_ONLY_ARCHS


@dataclasses.dataclass(frozen=True)
class BrokerConfig:
    """Broker service configuration (reference broker.py:19-31, entrypoint.sh)."""

    base_url: str = "http://127.0.0.1:8000/"
    loop_seconds: float = 5.0            # broker.py:19
    threading: bool = dataclasses.field(
        default_factory=lambda: os.environ.get("BROKER_THREADING") == "True"
    )
    log_dir: str = "logs"
    report_dir: str = "final_reports"
    # state-3 job lease (service/lease.py): a job stuck "in progress" longer
    # than this is reset to its requesting state on the next poll. 0 turns
    # recovery off. The reference had no such path — a crashed job stayed in
    # state 3 forever (SURVEY.md §5.3).
    lease_seconds: float = 600.0
    # drain cap per poll: the broker picks up every pending job each poll
    # (batched over shared search sets, service/compute_matches.py) up to
    # this many; the reference took one job per type per 5 s poll
    # (api_repository.py:53-63, broker.py:87)
    max_jobs_per_poll: int = 64

    @staticmethod
    def from_env(**overrides) -> "BrokerConfig":
        kwargs = {}
        if "BASE_URL" in os.environ:
            kwargs["base_url"] = os.environ["BASE_URL"]
        if "BROKER_LEASE_SECONDS" in os.environ:
            kwargs["lease_seconds"] = float(os.environ["BROKER_LEASE_SECONDS"])
        if "BROKER_MAX_JOBS_PER_POLL" in os.environ:
            kwargs["max_jobs_per_poll"] = int(
                os.environ["BROKER_MAX_JOBS_PER_POLL"])
        kwargs.update(overrides)
        return BrokerConfig(**kwargs)


def default_hyperparams() -> HyperParams:
    """The broker's production defaults (reference broker.py:36-59)."""
    return HyperParams()


def stream_index(streams: Sequence[str], stream: str) -> int:
    return list(streams).index(stream)
