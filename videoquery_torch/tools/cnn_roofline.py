"""Roofline account of the BN-Inception ensemble forward on the card.

Port of ``tools/cnn_roofline.py``. It measures the card's ceilings with
CUDA events over long runs of launches, best of 3:

- the achievable HBM read rate: a float32 sum of a 2 GiB bf16 array, 40
  times a run;
- square GEMM rates (8192^3, ``torch.matmul``): bf16; f32 with TF32 off,
  as the port's f32 networks run; TF32, as the bf16 networks' convs
  outside T1 run (widened to f32 with TF32 allowed);
- the GEMM rate at four of the network's implicit-GEMM conv shapes (the
  JAX tool's M, K and N; two chained GEMMs a step), in ``--dtype``.

It models the FLOPs and HBM bytes of one ensemble member's forward layer by
layer, times the port's ensemble forward in ``--dtype`` (rgb: 3 channels,
flow: 10; ``--splits`` members a stream, ``--images`` random images a
member; in bf16 the extraction path's forward: T1 on the stride-1 blocks,
cuDNN for the rest) and sets the time against the model at the measured
and at the nominal H100 SXM rates. Two byte models bound the traffic:

- unfused: every conv reads its input and writes its output (a block's
  input is read once a branch), pools read and write;
- ideal fusion: each block reads its input once and writes only its
  concat output; the reduce convs' outputs stay on chip.

The stem row is the port's plain 7x7/s2 conv over 224x224 (the JAX tool's
is its space-to-depth 4x4 conv over 112x112); every other row is the JAX
tool's for the same geometry. Bytes an element come from ``--dtype``.

    python -m videoquery_torch.tools.cnn_roofline [--images 200] [--splits 3] \\
        [--reps 8] [--dtype bfloat16|float32] [--device cuda|cpu]

On the CPU no ceiling is measured (each is null) and the forward is timed
by the host clock; the model and the nominal bounds are printed all the
same. The tables go to their own lines; the last line is
``{"cnn_roofline": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from videoquery_torch.nn.bn_inception import FLOW_CHANNELS, INCEPTION_BLOCKS, RGB_CHANNELS
from videoquery_torch.tools.flow_bench import full_f32, timeit

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
NOMINAL = {"hbm_bytes_s": 3.35e12, "bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# (label, output pixels an image, K, N): the JAX tool's conv-shape GEMMs
CONV_SHAPES = (("28x28 3x3 (K=1728,N=320)", 28 * 28, 1728, 320),
               ("14x14 3x3 (K=864,N=192)", 14 * 14, 864, 192),
               ("7x7 1x1 (K=1024,N=1024)", 7 * 7, 1024, 1024),
               ("28x28 1x1 (K=256,N=128)", 28 * 28, 256, 128))
STRIDE1_BLOCKS = frozenset(name for name, b in INCEPTION_BLOCKS if b["stride"] == 1)


@contextlib.contextmanager
def matmul_tf32(allow: bool):
    """torch.matmul's TF32 flag set for the body, the caller's back after."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def best_seconds(fn, reps: int, rounds: int = 3) -> float:
    """The least seconds a call of fn() over `rounds` runs of `reps` calls
    (flow_bench.timeit: CUDA events on the card)."""
    return min(timeit(fn, reps=reps)[0] for _ in range(rounds))


def measure_hbm_read(device, gib: float = 2, iters: int = 40) -> float:
    """Achievable read rate in bytes/s: a float32 sum of a bf16 array of
    `gib` GiB, `iters` sums a run."""
    n = int(gib * (1 << 29))
    x = torch.randn(n, dtype=torch.bfloat16, device=device)
    return 2 * n / best_seconds(lambda: x.sum(dtype=torch.float32), iters)


def measure_gemm(device, dtype: torch.dtype, m: int = 8192, iters: int = 20,
                 tf32: bool = False) -> float:
    """FLOP/s of an m x m x m torch.matmul in `dtype` (f32: TF32 as `tf32`
    says)."""
    a = torch.randn(m, m, device=device, dtype=dtype)
    b = torch.randn(m, m, device=device, dtype=dtype)
    out = torch.empty(m, m, device=device, dtype=dtype)
    with matmul_tf32(tf32):
        t = best_seconds(lambda: torch.matmul(a, b, out=out), iters)
    return 2 * m ** 3 / t


def measure_conv_shape_envelope(device, dtype: torch.dtype, images: int = 600,
                                iters: int = 10, tf32: bool = False) -> list[dict]:
    """FLOP/s at the network's own implicit-GEMM shapes: for each of
    CONV_SHAPES, [M, K] x [K, N] then [M, N] x [N, K] with M = images x the
    output pixels (600 = 3 members x 200 images). The square-GEMM rate is
    not reached here: N is 128-1024 and the 1x1 layers contract only K =
    cin, so this envelope is the network's own compute ceiling."""
    out = []
    for label, pixels, k, n in CONV_SHAPES:
        m = images * pixels
        a = torch.randn(m, k, device=device, dtype=dtype)
        b = torch.randn(k, n, device=device, dtype=dtype)
        c = torch.randn(n, k, device=device, dtype=dtype)
        y = torch.empty(m, n, device=device, dtype=dtype)
        z = torch.empty(m, k, device=device, dtype=dtype)

        def step():
            torch.matmul(a, b, out=y)
            return torch.matmul(y, c, out=z)

        with matmul_tf32(tf32):
            t = best_seconds(step, iters)
        out.append({"label": label, "m": m, "k": k, "n": n,
                    "flop_s": 2 * m * k * n * 2 / t})
        del a, b, c, y, z
    return out


def conv_cost(n, h, w, k, s, cin, cout, nbytes: int = 2):
    """(FLOPs, bytes read, bytes written, weight bytes, (ho, wo)) of a k x k
    stride-s conv of n images h x w x cin -> cout."""
    ho, wo = h // s, w // s
    flops = 2 * n * ho * wo * k * k * cin * cout
    read = n * h * w * cin * nbytes
    write = n * ho * wo * cout * nbytes
    weights = k * k * cin * cout * nbytes
    return flops, read, write, weights, (ho, wo)


def model(n_images: int, in_channels: int, nbytes: int = 2) -> list[tuple]:
    """Per-layer cost rows of one ensemble member over n_images:
    (name, FLOPs, HBM bytes read, HBM bytes written, weight bytes)."""
    rows = []

    def add(name, flops, r, w, wt):
        rows.append((name, flops, r, w, wt))

    def conv(name, hw, k, s, cin, cout):
        f, r, w, wt, _ = conv_cost(n, hw, hw, k, s, cin, cout, nbytes)
        add(name, f, r, w, wt)

    n, b_ = n_images, nbytes
    conv("conv1/7x7_s2", 224, 7, 2, in_channels, 64)      # the port's plain stem
    add("pool1 3x3/2", 0, n * 112 * 112 * 64 * b_, n * 56 * 56 * 64 * b_, 0)
    conv("conv2/3x3_reduce", 56, 1, 1, 64, 64)
    conv("conv2/3x3", 56, 3, 1, 64, 192)
    add("pool2 3x3/2", 0, n * 56 * 56 * 192 * b_, n * 28 * 28 * 192 * b_, 0)

    hw, cin = 28, 192
    for name, b in INCEPTION_BLOCKS:
        s = b["stride"]
        ho = hw // s
        x_bytes = n * hw * hw * cin * b_
        if b["c1"]:
            conv(f"{name}/1x1", hw, 1, 1, cin, b["c1"])
        conv(f"{name}/3x3_reduce", hw, 1, 1, cin, b["r3"])
        conv(f"{name}/3x3", hw, 3, s, b["r3"], b["c3"])
        conv(f"{name}/d3x3_reduce", hw, 1, 1, cin, b["rd"])
        conv(f"{name}/d3x3_1", hw, 3, 1, b["rd"], b["d1"])
        conv(f"{name}/d3x3_2", hw, 3, s, b["d1"], b["d2"])
        if s == 1:
            add(f"{name}/pool", 0, x_bytes, x_bytes, 0)
            if b["pp"]:
                conv(f"{name}/pool_proj", hw, 1, 1, cin, b["pp"])
            cout = b["c1"] + b["c3"] + b["d2"] + b["pp"]
        else:
            add(f"{name}/pool(s2)", 0, x_bytes, n * ho * ho * cin * b_, 0)
            cout = b["c3"] + b["d2"] + cin
        hw, cin = ho, cout
    add("global_pool 7x7", 0, n * 7 * 7 * 1024 * b_, n * 1024 * 4, 0)
    return rows


def ideal_bytes(rows) -> int:
    """The perfect-fusion floor: each inception block reads its input once
    and writes only its branches' outputs (the concat); the reduce and
    d3x3_1 intermediates and the stride-1 pool stay on chip; every other
    layer reads and writes; every weight is read once."""
    total, seen = 0, set()
    for name, _f, r, w, _wt in rows:
        block, _, leaf = name.partition("/")
        if block.startswith("inception"):
            if block not in seen:
                seen.add(block)
                total += r                   # the shared read of x
            if leaf in ("1x1", "3x3", "d3x3_2", "pool_proj", "pool(s2)"):
                total += w
        else:
            total += r + w
    return total + sum(row[4] for row in rows)


def unfused_bytes(rows) -> int:
    return sum(r + w + wt for _n, _f, r, w, wt in rows)


def block_table(rows) -> dict[str, dict]:
    """{block or layer: {"gflop", "unfused_gb"}} of one member's rows."""
    out: dict[str, dict] = {}
    for name, f, r, w, wt in rows:
        entry = out.setdefault(name.partition("/")[0], {"gflop": 0.0, "unfused_gb": 0.0})
        entry["gflop"] += f / 1e9
        entry["unfused_gb"] += (r + w + wt) / 1e9
    return out


def measure_ceilings(device, dtype: str) -> dict:
    """The card's ceilings: HBM read, the square GEMMs and the conv-shape
    envelope in `dtype` (f32: TF32 off)."""
    return {"hbm_read_bytes_s": measure_hbm_read(device),
            "gemm_flop_s": {"bfloat16": measure_gemm(device, torch.bfloat16, iters=50),
                            "float32": measure_gemm(device, torch.float32),
                            "tf32": measure_gemm(device, torch.float32, tf32=True)},
            "conv_shapes": measure_conv_shape_envelope(device, DTYPES[dtype])}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=200,
                    help="images a member a stream (8 clips x 25 ticks = 200, the "
                         "production batch)")
    ap.add_argument("--splits", type=int, default=3)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, or VIDEOQUERY_DEVICE)")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Measure, model and time; print the tables; return the account."""
    with full_f32():
        return _run(parse_args(argv))


def _run(args) -> dict:
    from videoquery_torch.core.device import resolve_device
    from videoquery_torch.nn.tsn import TwoStreamTSN

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    dtype, nbytes = DTYPES[args.dtype], DTYPES[args.dtype].itemsize
    ceilings = measure_ceilings(device, args.dtype) if on_card else None
    card = torch.cuda.get_device_name(device) if on_card else "cpu"
    nominal_compute = NOMINAL[args.dtype]
    if ceilings:
        gemm = ceilings["gemm_flop_s"]
        hbm = ceilings["hbm_read_bytes_s"]
        print(f"[ceilings] {card}: HBM read {hbm / 1e9:.1f} GB/s "
              f"({100 * hbm / NOMINAL['hbm_bytes_s']:.1f}% of 3.35 TB/s); GEMM 8192^3 bf16 "
              f"{gemm['bfloat16'] / 1e12:.1f} TFLOP/s ({100 * gemm['bfloat16'] / 989e12:.1f}% "
              f"of 989), f32 with TF32 off {gemm['float32'] / 1e12:.1f} "
              f"({100 * gemm['float32'] / 67e12:.1f}% of 67), TF32 {gemm['tf32'] / 1e12:.1f} "
              f"({100 * gemm['tf32'] / 495e12:.1f}% of 495)", flush=True)
        for row in ceilings["conv_shapes"]:
            print(f"[ceilings] conv-shape GEMM {row['label']}, M={row['m']}, {args.dtype}: "
                  f"{row['flop_s'] / 1e12:.1f} TFLOP/s", flush=True)
    else:
        print(f"[ceilings] not measured on {device}", flush=True)

    tsn = TwoStreamTSN.random(0, tuple(range(1, args.splits + 1)), device)
    rng = np.random.default_rng(0)
    k, n = args.splits, args.images
    streams = {}
    for stream, cin, ens in (("rgb", RGB_CHANNELS, tsn.rgb), ("flow", FLOW_CHANNELS, tsn.flow)):
        rows = model(n, cin, nbytes)
        flops = sum(r[1] for r in rows) * k
        route_flops = {                      # T1's blocks, and the convs outside them
            "t1": sum(r[1] for r in rows if r[0].partition("/")[0] in STRIDE1_BLOCKS) * k}
        route_flops["outside"] = flops - route_flops["t1"]
        unfused, ideal = unfused_bytes(rows) * k, ideal_bytes(rows) * k
        x = torch.from_numpy(rng.standard_normal((n, 224, 224, cin), np.float32)).to(
            device=device, dtype=dtype)
        sec, _ = timeit(ens.embed, x, reps=args.reps)
        del x

        def bounds(compute_rate, hbm_rate, tf32_rate):
            route = (route_flops["t1"] / compute_rate + route_flops["outside"] / tf32_rate
                     if args.dtype == "bfloat16" else flops / compute_rate)
            return {"compute_ms": flops / compute_rate * 1e3, "route_compute_ms": route * 1e3,
                    "unfused_ms": unfused / hbm_rate * 1e3, "ideal_ms": ideal / hbm_rate * 1e3}

        nominal = bounds(nominal_compute, NOMINAL["hbm_bytes_s"], NOMINAL["tf32"])
        measured = (bounds(ceilings["gemm_flop_s"][args.dtype],
                           ceilings["hbm_read_bytes_s"], ceilings["gemm_flop_s"]["tf32"])
                    if ceilings else None)
        streams[stream] = {
            "ms": sec * 1e3, "gflop": flops / 1e9, "tflop_s": flops / sec / 1e12,
            "unfused_gb": unfused / 1e9, "unfused_gb_s": unfused / sec / 1e9,
            "ideal_gb": ideal / 1e9, "t1_gflop": route_flops["t1"] / 1e9,
            "bounds_measured": measured, "bounds_nominal": nominal,
            "blocks": block_table(rows)}
        s = streams[stream]
        print(f"[{stream}] {k} members x {n} images, {args.dtype}, on {card}: "
              f"{s['ms']:.3f} ms | {s['gflop']:.1f} GFLOP -> {s['tflop_s']:.2f} TFLOP/s | "
              f"unfused {s['unfused_gb']:.3f} GB -> {s['unfused_gb_s']:.1f} GB/s | "
              f"ideal fusion {s['ideal_gb']:.3f} GB", flush=True)
        for tag, b in (("measured", measured), ("nominal H100 SXM", nominal)):
            if b is None:
                print(f"[{stream}] bounds at measured rates: not measured", flush=True)
                continue
            route = (f" (T1's blocks at bf16, the convs outside them at TF32: "
                     f"{b['route_compute_ms']:.3f})" if args.dtype == "bfloat16" else "")
            print(f"[{stream}] bounds at {tag} rates: compute {b['compute_ms']:.3f} ms{route} | "
                  f"unfused traffic {b['unfused_ms']:.3f} ms | ideal fusion "
                  f"{b['ideal_ms']:.3f} ms", flush=True)
        print(f"[{stream}] {'layer':18s} {'GFLOP':>9s} {'unfused GB':>11s}  (one member)")
        for block, v in s["blocks"].items():
            print(f"[{stream}] {block:18s} {v['gflop']:9.2f} {v['unfused_gb']:11.4f}")
    both = streams["rgb"]["ms"] + streams["flow"]["ms"]
    total = {"ms": both, "cnn_clips_s_8clip": 8e3 / both if n == 200 else None}
    print(f"[total] rgb + flow: {both:.3f} ms"
          + (f" (= {total['cnn_clips_s_8clip']:.2f} clips/s CNN-only ceiling for an 8-clip "
             f"batch of 25 ticks)" if n == 200 else ""), flush=True)
    return {"device": str(device), "card": card, "dtype": args.dtype, "images": n,
            "splits": k, "reps": args.reps, "ceilings": ceilings, "nominal": NOMINAL,
            "streams": streams, "total": total}


def main(argv=None) -> None:
    print(json.dumps({"cnn_roofline": run(argv)}), flush=True)


if __name__ == "__main__":
    main()
