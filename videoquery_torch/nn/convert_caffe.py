"""Caffemodel -> npz weight bundle converter.

A copy of ``videoquery/nn/convert_caffe.py`` that uses the port's
``nn/bn_inception.py``: it reads a binary .caffemodel (NetParameter
protobuf) with a self-contained protobuf wire-format reader (no caffe, no
generated protos) and writes the BN-folded parameter dict as the npz bundle
that ``--weights`` of the extraction CLI reads, byte for byte what the JAX
package's converter writes. Importing it loads numpy alone; ``convert`` and
the CLI import ``bn_inception`` (and with it torch) when called.

The reference extracts features with the caffe-action fork's CaffeNet over
the UCF101 split-{1,2,3} TSN caffemodels (calcSig_wOF.py:30,44-56,
calcSig_wOF_ensemble.sh:12-37). Those weight files are external artifacts;
this module is the bridge that imports them.

Conversion details:
- Caffe conv weights are [cout, cin, kh, kw]; ours are HWIO [kh, kw, cin, cout].
- The caffe-action "BN" layer (frozen: true everywhere in the deploy
  prototxts) stores 4 blobs: scale (gamma), shift (beta), mean, variance.
  Frozen BN is folded into the preceding conv via bn_inception.fold_bn.
- InnerProduct weights are [cout, cin] -> transposed to [cin, cout].
"""

from __future__ import annotations

import logging
import struct
from typing import Iterator

import numpy as np

log = logging.getLogger(__name__)

_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_I32 = 0, 1, 2, 5


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _WIRE_I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == _WIRE_LEN:
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == _WIRE_I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_blob(buf: memoryview) -> np.ndarray:
    """BlobProto: field 5 = packed float data, field 7 = BlobShape,
    fields 1-4 = legacy num/channels/height/width dims."""
    data: np.ndarray | None = None
    shape: list[int] = []
    legacy = {}
    for field, wire, val in _fields(buf):
        if field == 5 and wire == _WIRE_LEN:
            data = np.frombuffer(val, dtype="<f4")
        elif field == 5 and wire == _WIRE_I32:  # unpacked float (rare)
            v = struct.unpack("<f", val)[0]
            data = np.append(data if data is not None else np.empty(0, np.float32), v)
        elif field == 7 and wire == _WIRE_LEN:
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    if w2 == _WIRE_VARINT:
                        shape.append(int(v2))
                    else:  # packed varints
                        p = 0
                        mv = memoryview(v2)
                        while p < len(mv):
                            d, p = _read_varint(mv, p)
                            shape.append(d)
        elif field in (1, 2, 3, 4) and wire == _WIRE_VARINT:
            legacy[field] = int(val)
        elif field == 8 and wire == _WIRE_LEN:  # double_data
            data = np.frombuffer(val, dtype="<f8").astype(np.float32)
    if data is None:
        raise ValueError("blob without data")
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape:
        data = data.reshape(shape)
    return data


def _parse_layer(buf: memoryview) -> tuple[str, str, list[np.ndarray]]:
    """LayerParameter: 1=name, 2=type, 7=blobs (V1: 1=bottom... name=2? —
    V1LayerParameter uses 4=name, 5=type(enum), 6=blobs; handled below)."""
    name = typ = None
    blobs: list[np.ndarray] = []
    v1_name = None
    v1_blobs: list[np.ndarray] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == _WIRE_LEN:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 2 and wire == _WIRE_LEN:
            typ = bytes(val).decode("utf-8", "replace")
        elif field == 7 and wire == _WIRE_LEN:
            blobs.append(_parse_blob(val))
        elif field == 4 and wire == _WIRE_LEN:  # V1 name
            v1_name = bytes(val).decode("utf-8", "replace")
        elif field == 6 and wire == _WIRE_LEN:  # V1 blobs
            v1_blobs.append(_parse_blob(val))
    if name is None and v1_name is not None:
        name, blobs = v1_name, v1_blobs
    return name or "", typ or "", blobs


def read_caffemodel(path: str) -> dict[str, list[np.ndarray]]:
    """{layer_name: [blobs...]} for every parameterized layer."""
    with open(path, "rb") as f:
        raw = memoryview(f.read())
    layers: dict[str, list[np.ndarray]] = {}
    for field, wire, val in _fields(raw):
        # NetParameter: 100 = layer (LayerParameter), 2 = layers (V1)
        if field in (100, 2) and wire == _WIRE_LEN:
            name, _typ, blobs = _parse_layer(val)
            if blobs:
                layers[name] = blobs
    return layers


def convert(
    caffemodel_path: str,
    in_channels: int = 3,
    bn_eps: float = 1e-5,
    dtype=np.float32,
) -> dict[str, dict[str, np.ndarray]]:
    """Produce the BN-folded param dict for bn_inception.BNInception
    (in_channels 3: rgb; 10: flow)."""
    from videoquery_torch.nn import bn_inception

    layers = read_caffemodel(caffemodel_path)
    params: dict[str, dict[str, np.ndarray]] = {}
    for name, shape in bn_inception.conv_shapes(in_channels).items():
        kh, kw, cin, cout = shape
        blobs = layers.get(name)
        if blobs is None:
            raise KeyError(f"caffemodel missing conv layer {name!r}")
        w = blobs[0].reshape(cout, cin, kh, kw).transpose(2, 3, 1, 0)
        b = (blobs[1].reshape(cout) if len(blobs) > 1 else np.zeros(cout, np.float32))
        bn = layers.get(name + "_bn")
        if bn is not None:
            # caffe-action BN blobs: scale, shift, mean, variance
            scale, shift, mean, var = (x.reshape(-1) for x in bn[:4])
            w, b = bn_inception.fold_bn(w, b, scale, shift, mean, var, bn_eps)
        params[name] = {"w": w.astype(dtype), "b": b.astype(dtype)}
    fc = layers.get("fc-action")
    if fc is None:
        raise KeyError("caffemodel missing fc-action")
    # InnerProduct weight is [cout, cin]; V1 legacy blobs 1-pad it to
    # [1, 1, cout, cin] — normalize on the trailing (input) axis.
    fc_w = fc[0].reshape(-1, fc[0].shape[-1])
    params["fc-action"] = {
        "w": fc_w.T.astype(dtype),
        "b": fc[1].reshape(-1).astype(dtype),
    }
    return params


def save_npz(params: dict, path: str) -> None:
    flat = {}
    for layer, p in params.items():
        for k, v in p.items():
            flat[f"{layer}::{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_npz(path: str) -> dict[str, dict[str, np.ndarray]]:
    """A bundle written by save_npz: {layer: {'w', 'b'}}, keys stored flat
    as 'layer::w'."""
    params: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as flat:
        for key in flat.files:
            layer, k = key.split("::")
            params.setdefault(layer, {})[k] = flat[key]
    return params


def main(argv=None) -> None:
    """CLI: convert TSN caffemodels to the framework's npz bundles.

    Example (mirroring the reference ensemble layout,
    calcSig_wOF_ensemble.sh:12-37):
      python -m videoquery_torch.nn.convert_caffe \
          ucf101_split1_tsn_rgb_reference_bn_inception.caffemodel \
          --stream rgb --out weights/rgb_split1.npz
    """
    import argparse
    import os

    from videoquery_torch.nn import bn_inception

    parser = argparse.ArgumentParser(description="caffemodel -> npz converter")
    parser.add_argument("caffemodel", help="binary .caffemodel path")
    parser.add_argument("--stream", choices=["rgb", "flow"], required=True,
                        help="rgb (3-ch input) or flow (10-ch input)")
    parser.add_argument("--out", required=True, help="output .npz path")
    parser.add_argument("--bn_eps", type=float, default=1e-5)
    args = parser.parse_args(argv)
    in_channels = (bn_inception.RGB_CHANNELS if args.stream == "rgb"
                   else bn_inception.FLOW_CHANNELS)
    params = convert(args.caffemodel, in_channels=in_channels,
                     bn_eps=args.bn_eps)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_npz(params, args.out)
    n_params = sum(int(np.prod(v.shape)) for p in params.values()
                   for v in p.values())
    print(f"converted {len(params)} layers ({n_params/1e6:.1f}M params) "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
