"""A/B of one BN-Inception block on the card: the port's unfused block
(``BNInception._inception``: one cuDNN conv per branch, the pools, a concat)
against the fused kernel T1 (``kernels/inception_block.py``), the port's
counterpart of ``tools/inception_block_bench.py``.

Geometry as the JAX tool's: the ensemble's K members (``--splits``, the
same weights ``init_params(0, 3)`` in each, as the JAX tool stacks them)
each run ``--images`` images of one block's input, a ReLU'd random tensor
(block inputs are >= 0; T1's MAX pool relies on it), in ``--dtype``. For
every stride-1 block (default: all 8) it times, on the same input and in
turns (cuDNN, T1, T1, cuDNN; CUDA events over ``--reps`` runs each), the
unfused chain of K block calls and one T1 call for all K members, and the
plain version (``fused_inception_reference``) once over fewer runs; it
prints one line per block with the work's bound on an H100 SXM (989
TFLOP/s bf16, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s), and one
with the device time of each of T1's five launches in one call
(torch.profiler).

    python -m videoquery_torch.tools.inception_block_bench [--blocks inception_4b]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from videoquery_torch.core.device import resolve_device
from videoquery_torch.kernels import inception_block as t1
from videoquery_torch.nn import bn_inception as bi

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def block_geometry() -> dict[str, tuple[int, int, dict]]:
    """{name: (hw, cin, spec)} walking the post-pool2 chain (28x28, 192ch)."""
    hw, cin = 28, 192
    out = {}
    for name, b in bi.INCEPTION_BLOCKS:
        out[name] = (hw, cin, b)
        if b["stride"] == 1:
            cout = b["c1"] + b["c3"] + b["d2"] + b["pp"]
        else:
            cout = b["c3"] + b["d2"] + cin
        hw //= b["stride"]
        cin = cout
    return out


def stride1_blocks() -> list[str]:
    return [n for n, (_h, _c, b) in block_geometry().items() if b["stride"] == 1]


def block_work(hw: int, cin: int, spec: dict, images: int, members: int,
               dtype: torch.dtype) -> dict:
    """Compulsory work of one fused call: FLOPs of the seven convs (2 per
    multiply-add), bytes of x read once, the output written once and the
    weights and biases read once; the bound is the larger of the two times
    at the H100 SXM's peaks."""
    p = images * hw * hw
    c1, r3, c3, rd, d1, d2, pp = (spec[k] for k in ("c1", "r3", "c3", "rd", "d1", "d2", "pp"))
    macs = cin * (c1 + r3 + rd + pp) + 9 * (r3 * c3 + rd * d1 + d1 * d2)
    flops = 2.0 * p * members * macs
    esize = torch.empty((), dtype=dtype).element_size()
    cout = c1 + c3 + d2 + pp
    n_bias = c1 + r3 + rd + c3 + d1 + d2 + pp
    nbytes = (p * cin + members * p * cout + members * macs) * esize + members * n_bias * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def block_case(name: str, images: int, members: int, dtype: torch.dtype, dev,
               gen: torch.Generator, base: dict):
    """(x NHWC >= 0, T1's weights from K stacked copies of the block's
    parameters in the JAX layout)."""
    hw, cin, spec = block_geometry()[name]
    params = {key: {"w": np.stack([v["w"]] * members), "b": np.stack([v["b"]] * members)}
              for key, v in base.items() if key.startswith(name + "/")}
    x = (torch.randn((images, hw, hw, cin), generator=gen, device=dev)
         .abs_().mul_(0.3).to(dtype))
    return x, t1.block_weights(params, name, spec, dtype, dev)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over reps runs (CUDA events), after one
    warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


LAUNCHES_OF_T1 = ("1x1 x -> c1|r3|rd", "3x3 r3 -> c3", "3x3 rd -> d1", "3x3 d1 -> d2",
                  "pool + 1x1 pp")


def launch_breakdown(fn) -> list[float] | None:
    """Device ms of each kernel that one fn() call launches, in launch
    order, from a torch.profiler trace; None when the trace holds no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in kernels] or None


def run(blocks=None, images: int = 200, splits: int = 3, dtype: str = "bfloat16",
        reps: int = 10, device=None, log=print) -> list[dict]:
    """Time every block of ``blocks`` (default: the 8 stride-1 blocks);
    returns one dict per block: T1, cuDNN and plain ms, the bound, and T1's
    mean |difference| from the unfused block relative to its mean |value|."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the A/B times kernels on the card; it needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = DTYPES[dtype]
    geo = block_geometry()
    base = bi.init_params(0, 3)
    net = bi.BNInception(base).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name in blocks or stride1_blocks():
        hw, cin, spec = geo[name]
        x, wts = block_case(name, images, splits, dt, dev, gen, base)
        xc = x.permute(0, 3, 1, 2)           # NCHW view, channels-last memory

        def unfused():
            return [net._inception(name, spec, xc) for _ in range(splits)]

        def fused():
            return t1.fused_inception(wts, name, spec, x)

        with torch.no_grad():
            got = fused()[0].float()
            want = unfused()[0].permute(0, 2, 3, 1).float()
            rel = float((got - want).abs().mean() / want.abs().mean())
            del got, want
            lib_a = cuda_ms(unfused, reps)
            t1_a = cuda_ms(fused, reps)
            t1_b = cuda_ms(fused, reps)
            lib_b = cuda_ms(unfused, reps)
            plain = cuda_ms(lambda: t1.fused_inception_reference(wts, name, spec, x), 2)
            launches = launch_breakdown(fused)
        row = {"block": name, "hw": hw, "cin": cin, "t1_ms": (t1_a + t1_b) / 2,
               "cudnn_ms": (lib_a + lib_b) / 2, "plain_ms": plain, "rel_diff": rel,
               "launch_ms": launches, **block_work(hw, cin, spec, images, splits, dt)}
        rows.append(row)
        log(f"{name} {hw}x{hw} cin {cin}: T1 {row['t1_ms']:.3f} ms, cuDNN unfused "
            f"{row['cudnn_ms']:.3f} ms, plain {plain:.3f} ms; bound {row['bound_ms']:.3f} ms "
            f"({row['flops'] / 1e12:.3f} TFLOP, {row['bytes'] / 1e9:.3f} GB, "
            f"{row['bound_by']}); T1 vs cuDNN mean |diff| / mean |value| {rel:.2e}")
        if launches is not None and len(launches) == len(LAUNCHES_OF_T1):
            log(f"{name} T1's launches (profiler, one call): " + ", ".join(
                f"{what} {ms:.3f} ms" for what, ms in zip(LAUNCHES_OF_T1, launches)))
        else:
            log(f"{name} T1's launches: not measured (profiler saw {launches})")
        del x, xc, wts
    tot = {k: sum(r[k] for r in rows) for k in ("t1_ms", "cudnn_ms", "plain_ms", "bound_ms")}
    log(f"total of {len(rows)} blocks, {splits} x {images} images {dtype}: T1 "
        f"{tot['t1_ms']:.3f} ms, cuDNN unfused {tot['cudnn_ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", nargs="*", default=None,
                    help="default: all stride-1 blocks")
    ap.add_argument("--images", type=int, default=200)
    ap.add_argument("--splits", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    run(args.blocks, args.images, args.splits, args.dtype, args.reps)


if __name__ == "__main__":
    main()
