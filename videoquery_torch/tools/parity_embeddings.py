"""Embedding-level parity harness against the reference TSN pipeline.

Port of ``tools/parity_embeddings.py``. The reference's ground truth is
its checked-in feature CSVs (tests/data/features/...), produced by Caffe
forwards of the UCF101 TSN caffemodels (calcSig_wOF.py:30,173-176,
calcSig_wOF_ensemble.sh:12-37). The caffemodels and the source videos are
not in the repository; the day they are at hand, this closes the parity
loop on the card:

  python -m videoquery_torch.tools.parity_embeddings \\
      --weights_dir /path/to/caffemodels --videos /path/to/videos \\
      --fixtures tests/data/features/stock-video-clips_features --splits 1 2 3

It (1) converts every caffemodel (V1 or modern layout) to npz
(``nn/convert_caffe.py``), (2) runs the port's extraction CLI on the
videos at the reference geometry (340x256, 25 ticks, 10 s clips at 15
fps), (3) compares the clip embeddings with the fixture CSVs: cosine and
relative L2 a (video, split, stream), and exits 1 if a clip's cosine
falls below --min_cosine.

--selftest runs the whole loop on synthetic caffemodels (written with
``testing/caffe_wire.py``) and a synthetic video, with no external
artifact: the second extraction of the same video must equal the first
(cosine > 0.999999). ``--extract_args`` passes more flags to the
extraction CLI (a small geometry on the CPU, with VIDEOQUERY_DEVICE=cpu):

  VIDEOQUERY_DEVICE=cpu python -m videoquery_torch.tools.parity_embeddings --selftest \\
      --extract_args "--num_ticks 3 --fps 5 --clip_time 20 --new_width 160 --new_height 120"

Expected caffemodel names (reference calcSig_wOF_ensemble.sh:12-37):
  ucf101_split{K}_tsn_rgb_reference_bn_inception.caffemodel
  ucf101_split{K}_tsn_flow_reference_bn_inception.caffemodel
(or any layout: --rgb_pattern / --flow_pattern).
"""

from __future__ import annotations

import argparse
import glob
import os
import shlex
import tempfile

import numpy as np


def convert_all(weights_dir, splits, rgb_pattern, flow_pattern, out_dir):
    """Every split's rgb and flow caffemodel to <out_dir>/<stream>_split<k>.npz
    (the extraction CLI's --weights layout); returns {(stream, split): path}."""
    from videoquery_torch.nn import bn_inception
    from videoquery_torch.nn.convert_caffe import convert, save_npz

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for split in splits:
        for stream, pattern, cin in (("rgb", rgb_pattern, bn_inception.RGB_CHANNELS),
                                     ("flow", flow_pattern, bn_inception.FLOW_CHANNELS)):
            matches = glob.glob(os.path.join(weights_dir, pattern.format(split=split)))
            if not matches:
                raise SystemExit(f"no caffemodel for split {split} stream {stream} "
                                 f"(pattern {pattern!r} in {weights_dir})")
            npz = os.path.join(out_dir, f"{stream}_split{split}.npz")
            save_npz(convert(matches[0], in_channels=cin), npz)
            paths[(stream, split)] = npz
            print(f"[convert] {os.path.basename(matches[0])} -> {npz}", flush=True)
    return paths


def extract_videos(videos, weights_dir, splits, out_dir, extra_args=()):
    """The port's extraction CLI on a video, a directory of videos or
    "synthetic", with the converted weights."""
    from videoquery_torch.pipeline.extract import main as extract_main

    extract_main([videos, "--out", out_dir, "--weights", weights_dir,
                  "--splits", *map(str, splits), *extra_args])


def compare_trees(got_root, fixture_root):
    """Per-CSV cosine / relative L2 report of the rows two feature trees
    share. Returns the worst cosine."""
    from videoquery_torch.index.csvio import read_feature_tree

    fixture, got = {}, {}
    for root, rows in ((fixture_root, fixture), (got_root, got)):
        for video, split, csvf in read_feature_tree(root):
            for clip, vec in zip(csvf.clip_numbers, csvf.features):
                rows[(video, split, csvf.stream, int(clip))] = vec
    keys = sorted(set(fixture) & set(got))
    missing = len(set(fixture) - set(got))
    if not keys:
        raise SystemExit("no overlapping (video, split, stream, clip) rows "
                         "between extraction output and fixtures")
    if missing:
        print(f"[compare] WARNING: {missing} fixture rows missing from extraction output")
    by_group: dict[tuple, list] = {}
    for k in keys:
        a, b = fixture[k], got[k]
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        rel = float(np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-12))
        by_group.setdefault(k[:3], []).append((cos, rel))
    worst = 1.0
    print(f"{'video':32s} {'split':5s} {'stream':22s} "
          f"{'cos p50':>8s} {'cos min':>8s} {'relL2 p50':>9s}")
    for (video, split, stream), vals in sorted(by_group.items()):
        cs = np.array([v[0] for v in vals])
        rl = np.array([v[1] for v in vals])
        worst = min(worst, float(cs.min()))
        print(f"{video[:32]:32s} {split:<5d} {stream:22s} "
              f"{np.median(cs):8.4f} {cs.min():8.4f} {np.median(rl):9.4f}")
    return worst


def write_synthetic_caffemodels(wdir: str, splits=(1,), seed: int = 0) -> None:
    """Random BN-Inception caffemodels (modern layout) of both streams."""
    from videoquery_torch.nn import bn_inception
    from videoquery_torch.testing.caffe_wire import _layer

    rng = np.random.default_rng(seed)
    os.makedirs(wdir, exist_ok=True)
    for split in splits:
        for stream, cin in (("rgb", 3), ("flow", 10)):
            raw = b""
            for name, (kh, kw, ci, co) in bn_inception.conv_shapes(cin).items():
                w = rng.normal(size=(co, ci, kh, kw)).astype(np.float32) * 0.05
                b = rng.normal(size=(co,)).astype(np.float32) * 0.01
                raw += _layer(name, "Convolution", [w, b])
            raw += _layer("fc-action", "InnerProduct",
                          [rng.normal(size=(101, 1024)).astype(np.float32) * 0.01,
                           np.zeros(101, np.float32)])
            path = os.path.join(
                wdir, f"ucf101_split{split}_tsn_{stream}_reference_bn_inception.caffemodel")
            with open(path, "wb") as f:
                f.write(raw)


def selftest(extra_args=()) -> float:
    """Synthetic caffemodels -> convert -> extract a synthetic video twice
    (the written mp4 the second time) -> reload both CSV trees: every stage
    of the harness without external artifacts. Returns the worst cosine,
    which must exceed 0.999999 (the same video and weights). The caller's
    TF32 flags come back after it."""
    from videoquery_torch.tools.flow_bench import full_f32

    with full_f32(), tempfile.TemporaryDirectory(prefix="vq_parity_selftest_") as tmp:
        wdir = os.path.join(tmp, "caffemodels")
        write_synthetic_caffemodels(wdir)
        npz_dir = os.path.join(tmp, "npz")
        convert_all(wdir, [1], "ucf101_split{split}_tsn_rgb_reference_bn_inception.caffemodel",
                    "ucf101_split{split}_tsn_flow_reference_bn_inception.caffemodel", npz_dir)
        out_a, out_b = os.path.join(tmp, "out_a"), os.path.join(tmp, "out_b")
        extract_videos("synthetic", npz_dir, [1], out_a, extra_args)
        video = glob.glob(os.path.join(out_a, "*.mp4"))[0]
        extract_videos(video, npz_dir, [1], out_b, extra_args)
        worst = compare_trees(out_b, out_a)
    if not worst > 0.999999:
        raise AssertionError(f"selftest: repeat extraction diverged ({worst})")
    print(f"[selftest] OK (worst repeat-extraction cosine {worst:.8f})", flush=True)
    return worst


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--weights_dir")
    ap.add_argument("--videos", help="video file or directory")
    ap.add_argument("--fixtures", default="tests/data/features/stock-video-clips_features")
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--rgb_pattern", default="*split{split}*rgb*.caffemodel")
    ap.add_argument("--flow_pattern", default="*split{split}*flow*.caffemodel")
    ap.add_argument("--out", default="parity_out")
    ap.add_argument("--min_cosine", type=float, default=0.98,
                    help="exit nonzero if any clip embedding falls below")
    ap.add_argument("--extract_args", default="",
                    help="more flags for the extraction CLI, one string")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    extra = shlex.split(args.extract_args)
    if args.selftest:
        selftest(extra)
        return
    if not (args.weights_dir and args.videos):
        raise SystemExit("--weights_dir and --videos are required (or --selftest)")
    npz_dir = os.path.join(args.out, "npz")
    convert_all(args.weights_dir, args.splits, args.rgb_pattern, args.flow_pattern, npz_dir)
    csv_dir = os.path.join(args.out, "features")
    extract_videos(args.videos, npz_dir, args.splits, csv_dir, extra)
    worst = compare_trees(csv_dir, args.fixtures)
    print(f"[parity] worst per-clip cosine vs fixtures: {worst:.4f} "
          f"(threshold {args.min_cosine})")
    if worst < args.min_cosine:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
