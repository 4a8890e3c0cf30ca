"""Does every bf16 conv of the port's BN-Inception outside T1 round once?

The bf16 net runs its stem (``conv1/7x7_s2``, ``conv2/3x3_reduce``,
``conv2/3x3``) and the five convs of each stride-2 block (3c, 4e) as
``F.conv2d`` on the bf16 values widened to float32, the float32 bias inside
the call, and on the card lets cuDNN use TF32 for them
(``nn/bn_inception.py``). That rounds once only if the algorithm cuDNN picks
for each shape forms exact products (a bf16 value is exact in TF32) and
float32 sums; a Winograd or FFT algorithm would not. This runs one bf16
forward of the rgb net (``init_params(seed, 3)``, every bias ~N(0, 0.3))
over ``--images`` seeded frames of ``--size`` px, the extraction path's
call at the defaults, and holds each of those 13 convs, at the input the
forward gives it, against the same conv in float32 with TF32 off on the
same bf16 values, rounded once: the share of outputs that are bit-equal must
be at least ``BITWISE_SHARE`` (sums in another order land one ulp apart now
and then).

    python -m videoquery_torch.tools.conv_rounding [--images 200] [--size 224]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from videoquery_torch.core.device import resolve_device
from videoquery_torch.nn import bn_inception as bi
from videoquery_torch.tools.inception_block_bench import with_biases

BITWISE_SHARE = 0.999


def convs_outside_t1() -> list[str]:
    """The convs a bf16 forward runs as ``F.conv2d``, in its order: the
    stem's and those of the stride-2 blocks."""
    stride2 = {name for name, b in bi.INCEPTION_BLOCKS if b["stride"] == 2}
    return [name for name, *_ in bi._conv_names(bi.RGB_CHANNELS)
            if not name.startswith("inception") or name.split("/")[0] in stride2]


def run(images: int = 200, size: int = 224, seed: int = 0, device=None,
        log=print) -> dict[str, float]:
    """{conv name: share of its outputs bit-equal to the float32 conv
    rounded once}, for every conv the bf16 forward runs outside T1, in the
    forward's order."""
    dev = resolve_device(device)
    net = bi.BNInception(with_biases(bi.init_params(seed, bi.RGB_CHANNELS), seed + 1)).to(dev)
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy((rng.normal(size=(images, size, size, bi.RGB_CHANNELS)) * 50)
                              .astype(np.float32)).to(dev)
    shares: dict[str, float] = {}
    path_conv = net._conv

    def conv(name: str, x: torch.Tensor) -> torch.Tensor:
        y = path_conv(name, x)
        _k, pad, stride = net.specs[name]
        key = name.replace("/", "__")
        w = net.weights[key].to(torch.bfloat16).float()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            want = F.conv2d(x.float(), w, net.biases[key], stride=stride, padding=pad)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        want = want.relu_().to(torch.bfloat16)
        shares[name] = float((y == want).float().mean())
        log(f"{name} {list(x.shape)} -> {list(y.shape)}: {shares[name]:.6f} of outputs "
            "bit-equal to the f32 conv rounded once")
        return y

    net._conv = conv
    with torch.no_grad():
        net(frames.to(torch.bfloat16), head=False)
    return shares


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=200)
    ap.add_argument("--size", type=int, default=224)
    args = ap.parse_args(argv)
    shares = run(args.images, args.size)
    bad = [name for name, share in shares.items() if share < BITWISE_SHARE]
    print(f"{len(shares) - len(bad)} of {len(shares)} convs round once on >= {BITWISE_SHARE} "
          "of outputs")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
