"""BN-Inception's operations and bytes, layer by layer, from shapes.

A copy of ``videoquery_torch/tools/cnn_roofline.py``'s model (``conv_cost``
and ``model``): one ensemble member's forward over n images at 224x224,
each conv's 2 N Ho Wo k k Cin Cout multiply-adds, and the bytes of an
unfused forward. ``batch_flops`` sums it over a batch of the extraction
cell: every split of both streams over B clips x T ticks.
"""

from __future__ import annotations

# BN-Inception's blocks (the reference deploy prototxt; a copy of
# videoquery_torch/nn/bn_inception.py's INCEPTION_BLOCKS)
INCEPTION_BLOCKS: tuple[tuple[str, dict], ...] = (
    ("inception_3a", dict(c1=64, r3=64, c3=64, rd=64, d1=96, d2=96, pool="ave", pp=32, stride=1)),
    ("inception_3b", dict(c1=64, r3=64, c3=96, rd=64, d1=96, d2=96, pool="ave", pp=64, stride=1)),
    ("inception_3c", dict(c1=0, r3=128, c3=160, rd=64, d1=96, d2=96, pool="max", pp=0, stride=2)),
    ("inception_4a", dict(c1=224, r3=64, c3=96, rd=96, d1=128, d2=128, pool="ave", pp=128, stride=1)),
    ("inception_4b", dict(c1=192, r3=96, c3=128, rd=96, d1=128, d2=128, pool="ave", pp=128, stride=1)),
    ("inception_4c", dict(c1=160, r3=128, c3=160, rd=128, d1=160, d2=160, pool="ave", pp=128, stride=1)),
    ("inception_4d", dict(c1=96, r3=128, c3=192, rd=160, d1=192, d2=192, pool="ave", pp=128, stride=1)),
    ("inception_4e", dict(c1=0, r3=128, c3=192, rd=192, d1=256, d2=256, pool="max", pp=0, stride=2)),
    ("inception_5a", dict(c1=352, r3=192, c3=320, rd=160, d1=224, d2=224, pool="ave", pp=128, stride=1)),
    ("inception_5b", dict(c1=352, r3=192, c3=320, rd=192, d1=224, d2=224, pool="max", pp=128, stride=1)),
)


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


def batch_flops(splits: int, clips: int, ticks: int, rgb_channels: int = 3,
                flow_channels: int = 10) -> float:
    """The FLOPs of one extraction batch's networks: splits x (rgb + flow)
    members over clips x ticks images each."""
    n = clips * ticks
    return float(splits * (sum(r[1] for r in model(n, rgb_channels))
                           + sum(r[1] for r in model(n, flow_channels))))
