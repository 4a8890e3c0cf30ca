"""I3D's operations and bytes, layer by layer, from shapes.

The layer list and widths of arXiv:1705.07750 / kinetics-i3d ``i3d.py``
(``InceptionI3d``, as ``benchmark/reference/i3d.py`` holds them): every
Unit3D conv's ``2 N To Ho Wo kt kh kw Cin Cout`` operations, and the bytes
an unfused forward must move (each conv's and pool's input read once, its
output written once, its weights read once), with TensorFlow SAME output
sizes (``ceil(n / s)``). The logits head is not counted: the extraction
step stops at the signature. ``batch_flops`` and ``batch_least_time_s`` sum
a batch of the I3D extraction cell: both streams over B clips, the rgb
volume of every frame and the flow volume of every pair.
"""

from __future__ import annotations

from benchmark import stats
from benchmark.reference.i3d import LAYERS, MIXED_WIDTHS


def _out(n: int, s: int) -> int:
    return -(-n // s)


def model(n: int, frames: int, hw: int, in_channels: int, nbytes: int = 2) -> list[tuple]:
    """Per-layer cost rows of one stream's forward over n volumes of frames
    x hw x hw x in_channels: (name, FLOPs, bytes read, bytes written,
    weight bytes)."""
    rows = []
    shape = [frames, hw, hw]
    cin = in_channels

    def vol(dims):
        return dims[0] * dims[1] * dims[2]

    def conv(name, dims, k, s, c_in, c_out):
        out = [_out(d, st) for d, st in zip(dims, s)]
        taps = k[0] * k[1] * k[2]
        rows.append((name, 2 * n * vol(out) * taps * c_in * c_out,
                     n * vol(dims) * c_in * nbytes, n * vol(out) * c_out * nbytes,
                     taps * c_in * c_out * nbytes))
        return out

    def pool(name, dims, s, c):
        out = [_out(d, st) for d, st in zip(dims, s)]
        rows.append((name, 0, n * vol(dims) * c * nbytes, n * vol(out) * c * nbytes, 0))
        return out

    one, three = (1, 1, 1), (3, 3, 3)
    for layer in LAYERS:
        kind, name = layer[0], layer[1]
        if kind == "conv":
            _k, _n, k, s, cout = layer
            shape = conv(name, shape, k, s, cin, cout)
            cin = cout
        elif kind == "pool":
            shape = pool(name, shape, layer[3], cin)
        else:
            b0, b1a, b1b, b2a, b2b, b3 = MIXED_WIDTHS[name]
            conv(f"{name}/b0", shape, one, one, cin, b0)
            conv(f"{name}/b1a", shape, one, one, cin, b1a)
            conv(f"{name}/b1b", shape, three, one, b1a, b1b)
            conv(f"{name}/b2a", shape, one, one, cin, b2a)
            conv(f"{name}/b2b", shape, three, one, b2a, b2b)
            pool(f"{name}/b3 pool", shape, one, cin)
            conv(f"{name}/b3", shape, one, one, cin, b3)
            cin = b0 + b1b + b2b + b3
    return rows


def _streams(clips: int, rgb_frames: int, hw: int):
    return (model(clips, rgb_frames, hw, 3), model(clips, rgb_frames - 1, hw, 2))


def batch_flops(clips: int, rgb_frames: int, hw: int = 224) -> float:
    """The FLOPs of one extraction batch's networks: the rgb member over
    clips x rgb_frames frames, the flow member over the rgb_frames - 1
    pairs."""
    return float(sum(r[1] for rows in _streams(clips, rgb_frames, hw) for r in rows))


def batch_least_time_s(clips: int, rgb_frames: int, hw: int = 224) -> float:
    """The least time the card could take for one batch's networks: each
    layer's larger bound (operations at the bf16 peak, or bytes at the HBM
    peak), summed over the layers, which run one after another."""
    return sum(stats.least_time_s(r[1], r[2] + r[3] + r[4])
               for rows in _streams(clips, rgb_frames, hw) for r in rows)
