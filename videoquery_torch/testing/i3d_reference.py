"""I3D's forward pass in plain PyTorch, float32: the reference the port's
``nn/i3d.py`` is held to.

Carreira & Zisserman, "Quo Vadis, Action Recognition? A New Model and the
Kinetics Dataset", CVPR 2017 (arXiv:1705.07750), as
``github.com/deepmind/kinetics-i3d``'s ``i3d.py`` builds ``InceptionI3d``:
``Unit3D`` convs (3D conv, BN, ReLU) with TensorFlow ``SAME`` padding, max
pools with ``SAME`` padding, nine ``Mixed`` blocks of four branches (1x1x1;
1x1x1 -> 3x3x3; 1x1x1 -> 3x3x3; 3x3x3 max pool -> 1x1x1), then
``Logits``: AvgPool3d 2x7x7 VALID, a 1x1x1 conv with bias, and the mean
over time. Every op is a plain ``torch`` call on NCDHW tensors, in float32
with TF32 off while it runs; padding is always an explicit ``F.pad``. No
kernel, cache or batching trick, and nothing of JAX, of ``videoquery``, or
of the port's ``nn/`` or ``kernels/`` is imported.

Departures from ``i3d.py``:

- BN is folded into each conv's weight and bias (a frozen BN is an affine
  map of the conv's output, so this is exact); ``params`` holds one
  ``{"w": DHWIO, "b": [cout]}`` a conv, as ``nn/i3d.py::init_params``
  gives them.
- Weights are seeded, not the Kinetics-400 checkpoints (not in the
  repository).
- The signature: the logits' pool is a 2 x H' x W' VALID average over
  ``Mixed_5c`` (2 x 7 x 7 at 224 x 224, the published pool; the whole
  plane at the tests' smaller sizes), averaged over time; with one time
  step left, that step's plane mean. The logits are the 1x1x1 conv on the
  pooled tensor, averaged over time, as the paper's test mode does. No
  dropout (inference).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# (b0, b1a, b1b, b2a, b2b, b3) of each Mixed block (i3d.py, the paper's Fig. 3)
MIXED_WIDTHS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
LOGITS = "Logits/Conv3d_0c_1x1"


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow SAME: out = ceil(n / s); the padding total split with the
    extra cell at the end."""
    out = math.ceil(n / s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k, s, value: float) -> torch.Tensor:
    pads = [same_pads(n, kk, ss) for n, kk, ss in zip(x.shape[2:], k, s)]
    (t0, t1), (h0, h1), (w0, w1) = pads
    return F.pad(x, (w0, w1, h0, h1, t0, t1), value=value)


def unit3d(params: dict, name: str, x: torch.Tensor, stride=(1, 1, 1), cast=None):
    """Conv (BN folded), SAME padding, ReLU. ``cast`` rounds the conv's
    input and weights (a lower precision's control)."""
    w = torch.as_tensor(params[name]["w"], device=x.device).float().permute(4, 3, 0, 1, 2)
    b = torch.as_tensor(params[name]["b"], device=x.device).float()
    k = tuple(w.shape[2:])
    x = _pad_same(x, k, stride, 0.0)
    if cast is not None:
        x, w = cast(x), cast(w)
    return F.relu(F.conv3d(x, w, b, stride=stride))


def max_pool(x: torch.Tensor, k, s) -> torch.Tensor:
    return F.max_pool3d(_pad_same(x, k, s, -math.inf), k, s)


def mixed(params: dict, name: str, x: torch.Tensor, cast=None) -> torch.Tensor:
    b0 = unit3d(params, f"{name}/Branch_0/Conv3d_0a_1x1", x, cast=cast)
    b1 = unit3d(params, f"{name}/Branch_1/Conv3d_0a_1x1", x, cast=cast)
    b1 = unit3d(params, f"{name}/Branch_1/Conv3d_0b_3x3", b1, cast=cast)
    b2 = unit3d(params, f"{name}/Branch_2/Conv3d_0a_1x1", x, cast=cast)
    b2 = unit3d(params, f"{name}/Branch_2/Conv3d_0b_3x3", b2, cast=cast)
    b3 = max_pool(x, (3, 3, 3), (1, 1, 1))
    b3 = unit3d(params, f"{name}/Branch_3/Conv3d_0b_1x1", b3, cast=cast)
    return torch.cat([b0, b1, b2, b3], dim=1)


def mixed_5c(params: dict, x: torch.Tensor, cast=None) -> torch.Tensor:
    """NDHWC x -> Mixed_5c's output, NCDHW float32."""
    y = x.float().permute(0, 4, 1, 2, 3)
    y = unit3d(params, "Conv3d_1a_7x7", y, (2, 2, 2), cast)
    y = max_pool(y, (1, 3, 3), (1, 2, 2))
    y = unit3d(params, "Conv3d_2b_1x1", y, cast=cast)
    y = unit3d(params, "Conv3d_2c_3x3", y, cast=cast)
    y = max_pool(y, (1, 3, 3), (1, 2, 2))
    y = mixed(params, "Mixed_3b", y, cast)
    y = mixed(params, "Mixed_3c", y, cast)
    y = max_pool(y, (3, 3, 3), (2, 2, 2))
    for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
        y = mixed(params, name, y, cast)
    y = max_pool(y, (2, 2, 2), (2, 2, 2))
    y = mixed(params, "Mixed_5b", y, cast)
    return mixed(params, "Mixed_5c", y, cast)


def logits_pool(y: torch.Tensor) -> torch.Tensor:
    """Mixed_5c [N, C, T', H', W'] -> [N, C, T' - 1, 1, 1]: the 2 x H' x W'
    VALID average (one step's plane mean where T' is 1)."""
    kt = min(2, y.shape[2])
    return F.avg_pool3d(y, (kt,) + tuple(y.shape[3:]), stride=1)


@torch.no_grad()
def forward(params: dict, x: torch.Tensor, cast=None) -> dict[str, torch.Tensor]:
    """NDHWC x [N, T, H, W, C] -> {'global_pool': [N, 1024], 'logits': [N,
    classes]}, float32, TF32 off."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        pooled = logits_pool(mixed_5c(params, x, cast))           # [N, C, T'', 1, 1]
        w = torch.as_tensor(np.asarray(params[LOGITS]["w"]), device=x.device).float()
        b = torch.as_tensor(np.asarray(params[LOGITS]["b"]), device=x.device).float()
        logits = F.conv3d(pooled, w.t()[:, :, None, None, None], b)
        return {"global_pool": pooled.mean(dim=(2, 3, 4)),
                "logits": logits.mean(dim=(2, 3, 4))}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def embed(params: dict, x: torch.Tensor, cast=None) -> torch.Tensor:
    """The 1024-d signature of each volume of x: f32 [N, 1024]."""
    return forward(params, x, cast)["global_pool"]
