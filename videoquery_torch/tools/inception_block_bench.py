"""A/B of one BN-Inception block on the card: the fused kernel T1
(``kernels/inception_block.py``) against the same block as a bare chain of
cuDNN calls (``cudnn_block``: each conv ``F.conv2d`` with the bias inside and
ReLU in place, the pool, one concat, in the activation type and
channels-last, as the extraction path's tensors lie), the port's
counterpart of ``tools/inception_block_bench.py``. The chain is the
library yardstick only: it rounds the sum and the bias in the activation
type, and the port never runs it in T1's place.

Geometry as the JAX tool's: the ensemble's K members (``--splits``, the
same weights ``init_params(0, 3)`` in each, as the JAX tool stacks them,
with every bias drawn ~N(0, 0.3) as BN-folded weights have them) each run
``--images`` images of one block's input, a ReLU'd random tensor (block
inputs are >= 0; T1's MAX pool relies on it), in ``--dtype``. ``--splits
1`` is the extraction path's geometry (one net's 200 images a call); 3 the
JAX tool's (x shared by the members). For every stride-1 block (default:
all 8) it holds T1's output against its plain version
(``fused_inception_reference``) at that shape, then times, on the same
input and in turns (cuDNN, T1, T1, cuDNN; CUDA events over ``--reps`` runs
each), K chains and one T1 call for all K members, and the plain version
once over fewer runs; it prints one line per block with the agreement, the
work's bound on an H100 SXM (989 TFLOP/s bf16, 67 TFLOP/s f32 outside the
tensor cores, 3.35 TB/s), and one with the device time of each of T1's
device launches in one call (torch.profiler). It exits 1 unless every block
meets T1's criterion (bf16: ``bf16_agreement``; f32: rtol 1e-4 / atol 1e-5).

    python -m videoquery_torch.tools.inception_block_bench [--blocks inception_4b] [--splits 1]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from videoquery_torch.core.device import resolve_device
from videoquery_torch.kernels import inception_block as t1
from videoquery_torch.nn import bn_inception as bi

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# T1's bf16 criterion against its plain version: this share of outputs
# within one bf16 ulp, and max |diff| at most this part of the largest output
BF16_SHARE, BF16_REL = 0.99, 1 / 64
F32_RTOL, F32_ATOL = 1e-4, 1e-5    # f32: only the order of sums differs
BIAS_STD = 0.3


def bf16_agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(share of outputs within one bf16 ulp of each other, max |diff| over
    the largest |value|): T1's bf16 criterion. The ulp is that of the larger
    magnitude, 2**(e - 8) for a value in [2**(e-1), 2**e)."""
    got, want = got.float(), want.float()
    top = torch.maximum(got.abs(), want.abs())
    exp = torch.frexp(top).exponent
    ulp = torch.where(top > 0, torch.ldexp(torch.ones_like(top), exp - 8),
                      torch.zeros_like(top))
    diff = (got - want).abs()
    return float((diff <= ulp).float().mean()), float(diff.max() / want.abs().max())


def with_biases(params: dict, seed: int) -> dict:
    """``params`` with every bias redrawn ~N(0, BIAS_STD) from a seeded numpy
    generator (``init_params`` draws zeros; BN-folded weights do not)."""
    rng = np.random.default_rng(seed)
    return {k: {"w": v["w"],
                "b": (rng.normal(size=np.shape(v["b"])) * BIAS_STD).astype(np.float32)}
            for k, v in params.items()}


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


# T1's device launches in one call, in launch order, by activation type
LAUNCHES_OF_T1 = {
    torch.bfloat16: ("x tile: 1x1 x -> c1|r3|rd and pool + 1x1 pp",
                     "3x3 r3 -> c3 and rd -> d1", "3x3 d1 -> d2"),
    torch.float32: ("1x1 x -> c1|r3|rd", "3x3 r3 -> c3", "3x3 rd -> d1", "3x3 d1 -> d2",
                    "pool + 1x1 pp"),
}


def cudnn_block(weights: dict, spec: dict, x: torch.Tensor) -> torch.Tensor:
    """The block as a chain of cuDNN calls on NCHW x (channels-last memory),
    in x's dtype: ``weights`` {layer: (OIHW weight, bias)} in that dtype."""
    def conv(layer, inp):
        w, b = weights[layer]
        return F.relu(F.conv2d(inp, w, b, padding=w.shape[-1] // 2), inplace=True)

    branches = [conv("1x1", x)] if spec["c1"] else []
    branches.append(conv("3x3", conv("3x3_reduce", x)))
    branches.append(conv("double_3x3_2", conv("double_3x3_1", conv("double_3x3_reduce", x))))
    pool = (bi.avg_pool if spec["pool"] == "ave" else bi.max_pool)(x, 3, 1, 1)
    branches.append(conv("pool_proj", pool))
    return torch.cat(branches, dim=1)


def launch_breakdown(fn, attempts: int = 3) -> list[float] | None:
    """Device ms of each kernel that one fn() call launches, in launch
    order, from the torch.profiler trace (of ``attempts``) that shows the
    most kernels (a trace now and then misses one); None when no trace
    holds device time."""
    from torch.profiler import ProfilerActivity, profile

    best: list[float] = []
    fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        if len(kernels) > len(best):
            best = [e.time_range.elapsed_us() / 1e3 for e in kernels]
    return best or None


def run(blocks=None, images: int = 200, splits: int = 3, dtype: str = "bfloat16",
        reps: int = 10, device=None, log=print) -> list[dict]:
    """Check and time every block of ``blocks`` (default: the 8 stride-1
    blocks); returns one dict per block: T1's agreement with its plain
    version at this shape (``share_1ulp`` and ``rel_err`` as
    ``bf16_agreement`` gives them, ``max_abs_err``, ``ok`` by the criterion
    of the dtype), T1, cuDNN and plain ms, the bound, T1's device launches a
    call and their ms, and T1's mean |difference| from the cuDNN chain
    relative to its mean |value| (the chain rounds twice: a yardstick, not a
    reference)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the A/B times kernels on the card; it needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = DTYPES[dtype]
    geo = block_geometry()
    base = with_biases(bi.init_params(0, 3), 1)
    net = bi.BNInception(base).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name in blocks or stride1_blocks():
        hw, cin, spec = geo[name]
        x, wts = block_case(name, images, splits, dt, dev, gen, base)
        xc = x.permute(0, 3, 1, 2)           # NCHW view, channels-last memory
        lib_w = {key.split("__")[1]: (net.weights[key].to(dt), net.biases[key].to(dt))
                 for key in net.weights if key.startswith(name + "__")}

        def unfused():
            return [cudnn_block(lib_w, spec, xc) for _ in range(splits)]

        def fused():
            return t1.fused_inception(wts, name, spec, x)

        with torch.no_grad():
            got = fused()
            want = t1.fused_inception_reference(wts, name, spec, x)
            share, rel = bf16_agreement(got, want)
            err = float((got.float() - want.float()).abs().max())
            ok = (share >= BF16_SHARE and rel <= BF16_REL if dt == torch.bfloat16
                  else bool(torch.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)))
            lib = unfused()[0].permute(0, 2, 3, 1).float()
            rel_lib = float((got[0].float() - lib).abs().mean() / lib.abs().mean())
            del got, want, lib
            lib_a = cuda_ms(unfused, reps)
            t1_a = cuda_ms(fused, reps)
            t1_b = cuda_ms(fused, reps)
            lib_b = cuda_ms(unfused, reps)
            plain = cuda_ms(lambda: t1.fused_inception_reference(wts, name, spec, x), 2)
            launches = launch_breakdown(fused)
        row = {"block": name, "hw": hw, "cin": cin, "t1_ms": (t1_a + t1_b) / 2,
               "cudnn_ms": (lib_a + lib_b) / 2, "plain_ms": plain, "share_1ulp": share,
               "rel_err": rel, "max_abs_err": err, "ok": ok, "rel_diff_cudnn": rel_lib,
               "launch_ms": launches, "device_launches": len(launches or ()),
               **block_work(hw, cin, spec, images, splits, dt)}
        rows.append(row)
        log(f"{name} {hw}x{hw} cin {cin}: against the plain version {share:.5f} of outputs "
            f"within one bf16 ulp, max |diff| / max |value| {rel:.2e}, max abs err {err:.3e}"
            f"{'' if ok else ' FAILS the criterion'}; T1 {row['t1_ms']:.3f} ms, cuDNN chain "
            f"{row['cudnn_ms']:.3f} ms, plain {plain:.3f} ms; bound {row['bound_ms']:.3f} ms "
            f"({row['flops'] / 1e12:.3f} TFLOP, {row['bytes'] / 1e9:.3f} GB, "
            f"{row['bound_by']}); T1 vs cuDNN chain mean |diff| / mean |value| {rel_lib:.2e}")
        if launches is not None and len(launches) == len(LAUNCHES_OF_T1[dt]):
            log(f"{name} T1's {len(launches)} device launches (profiler, one call): " + ", ".join(
                f"{what} {ms:.3f} ms" for what, ms in zip(LAUNCHES_OF_T1[dt], launches)))
        else:
            log(f"{name} T1's launches: not measured (profiler saw {launches})")
        del x, xc, wts, lib_w
    tot = {k: sum(r[k] for r in rows) for k in ("t1_ms", "cudnn_ms", "plain_ms", "bound_ms")}
    log(f"total of {len(rows)} blocks, {splits} x {images} images {dtype}: T1 "
        f"{tot['t1_ms']:.3f} ms, cuDNN chain {tot['cudnn_ms']:.3f} ms, plain "
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
    rows = run(args.blocks, args.images, args.splits, args.dtype, args.reps)
    if not all(r["ok"] for r in rows):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
