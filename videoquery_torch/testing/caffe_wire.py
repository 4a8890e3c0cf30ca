"""A writer of the caffemodel wire format (protobuf, no schema), for
synthetic caffemodels: NetParameter.layer (the modern LayerParameter, field
100, with BlobProto shapes) and NetParameter.layers (the V1 layout of the
TSN era's saves, field 2, with legacy 4-d dims and enum layer types).

The port's copy of the writer the JAX package's tests define
(tests/test_nn.py: ``_varint``, ``_len_field``, ``_blob``, ``_layer``,
``_scalar_field``, ``_blob_v1``, ``_layer_v1``); the port imports nothing
of the tests, and tests/test_torch_copies.py holds the two to the same
bytes. ``tools/parity_embeddings.py --selftest`` writes its caffemodels
with it.
"""

from __future__ import annotations

import numpy as np


def _varint(n):
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _len_field(field, payload):
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _blob(arr):
    data = np.asarray(arr, "<f4").ravel().tobytes()
    shape_payload = b"".join(_varint(d) for d in np.asarray(arr).shape)
    shape = _len_field(1, shape_payload)  # packed dims
    return _len_field(5, data) + _len_field(7, shape)


def _layer(name, typ, blobs):
    payload = _len_field(1, name.encode()) + _len_field(2, typ.encode())
    for b in blobs:
        payload += _len_field(7, _blob(b))
    return _len_field(100, payload)


def _scalar_field(field, n):
    return _varint((field << 3) | 0) + _varint(n)


def _blob_v1(arr):
    """Legacy 4-D dims + packed float data, no BlobShape submessage."""
    a = np.asarray(arr, "<f4")
    dims = list(a.shape)
    while len(dims) < 4:
        dims.insert(0, 1)  # caffe legacy blobs are always 4-d (1-padded)
    payload = b"".join(_scalar_field(i + 1, d) for i, d in enumerate(dims))
    return payload + _len_field(5, a.ravel().tobytes())


def _layer_v1(name, type_enum, blobs, bottom="x", top="y"):
    payload = _len_field(2, bottom.encode()) + _len_field(3, top.encode())
    payload += _len_field(4, name.encode())
    payload += _scalar_field(5, type_enum)  # V1 type is an enum varint
    for b in blobs:
        payload += _len_field(6, _blob_v1(b))
    return _len_field(2, payload)  # NetParameter.layers (V1) = field 2
