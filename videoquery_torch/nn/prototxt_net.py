"""Execute a Caffe deploy prototxt as a PyTorch program.

Port of ``videoquery/nn/prototxt_net.py``, the parity backstop for the
hand-transcribed architecture in ``bn_inception.py``: the forward graph is
built from the reference deploy definition
(src/features_GPU_compute/models/ucf101/tsn_bn_inception_{rgb,flow}_deploy
.prototxt) and run layer by layer, so connectivity, stride, padding or
pooling-mode drift in the transcription shows at the output.

Layer coverage is what the TSN deploy nets use: Convolution, BN (frozen:
identity here, the converter folds it into the conv), ReLU, Pooling
(MAX/AVE with Caffe's ceil-mode arithmetic), Concat, Dropout (identity at
test time, calcSig_wOF.py:44-46 runs caffe.TEST), InnerProduct. Blobs are
NCHW inside; the input, the flattened InnerProduct operand and the
global_pool output follow the JAX executor's NHWC order.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from videoquery_torch.nn.bn_inception import avg_pool, max_pool
from videoquery_torch.nn.prototxt import as_list, load_net


def _conv_param(layer: Mapping[str, Any]) -> tuple[int, int, int]:
    p = layer["convolution_param"]
    return (int(p.get("kernel_size", 1)), int(p.get("pad", 0)),
            int(p.get("stride", 1)))


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(a, torch.Tensor)
                           else a, dtype=torch.float32, device=like.device)


def _nhwc_flat(y: torch.Tensor) -> torch.Tensor:
    """A blob flattened per sample, [N, C, H, W] in NHWC order (the JAX
    executor's reshape)."""
    if y.dim() == 4:
        y = y.permute(0, 2, 3, 1)
    return y.reshape(y.shape[0], -1)


@torch.no_grad()
def apply_prototxt(
    path: str,
    params: Mapping[str, Mapping[str, Any]],
    x: torch.Tensor,                  # NHWC, preprocessed
    outputs: tuple[str, ...] = ("global_pool", "fc-action"),
) -> dict[str, torch.Tensor]:
    """Run the deploy net defined at `path` with BN-folded `params`, the
    JAX package's layout ({layer: {"w": HWIO conv or [in, out] fc, "b"}},
    numpy or torch; what ``convert_caffe`` writes and ``init_params``
    draws). BN layers are identity because folding already happened."""
    net = load_net(path)
    blobs: dict[str, torch.Tensor] = {"data": x.permute(0, 3, 1, 2)}

    def get(name):
        if name not in blobs:
            raise KeyError(f"prototxt references undefined blob {name!r}")
        return blobs[name]

    for layer in net["layer"]:
        typ = layer["type"]
        name = layer["name"]
        bottoms = as_list(layer.get("bottom"))
        tops = as_list(layer.get("top"))
        if typ == "Convolution":
            k, pad, stride = _conv_param(layer)
            h = get(bottoms[0])
            w = _tensor(params[name]["w"], h).permute(3, 2, 0, 1)     # HWIO -> OIHW
            y = F.conv2d(h.float(), w, _tensor(params[name]["b"], h), stride=stride,
                         padding=pad).to(h.dtype)
        elif typ == "BN":
            y = get(bottoms[0])  # frozen BN folded into the conv weights
        elif typ == "ReLU":
            y = F.relu(get(bottoms[0]))
        elif typ == "Pooling":
            p = layer["pooling_param"]
            k = int(p.get("kernel_size", 1))
            s = int(p.get("stride", 1))
            pad = int(p.get("pad", 0))
            pool = max_pool if p.get("pool") == "MAX" else avg_pool
            y = pool(get(bottoms[0]), k, s, pad)
        elif typ == "Concat":
            y = torch.cat([get(b) for b in bottoms], dim=1)
        elif typ == "Dropout":
            y = get(bottoms[0])  # caffe.TEST: identity
        elif typ == "InnerProduct":
            h = _nhwc_flat(get(bottoms[0])).float()
            p = params[name]
            y = h @ _tensor(p["w"], h) + _tensor(p["b"], h)
        else:
            raise NotImplementedError(f"layer type {typ!r} ({name})")
        blobs[tops[0]] = y

    out = {}
    for want in outputs:
        y = blobs[want]
        if want == "global_pool":
            y = _nhwc_flat(y).float()
        out[want] = y
    return out
