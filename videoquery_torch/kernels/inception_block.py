"""T1: one stride-1 BN-Inception block, fused (``csrc/inception_block.cu``).

Port of ``tools/inception_pallas.py::fused_inception`` (TPU kernel
``_block_kernel``). NHWC x [N, H, W, Cin] -> [N, H, W, Cout], the concat of
the 1x1, 3x3, double-3x3 and pool-projection branches, every conv
relu(sum + bias) with f32 sums and the result in x's dtype (float32 or
bfloat16); the intermediates r3, rd and d1 are rounded to that dtype, as the
TPU kernel rounds them.

``params`` is the JAX package's layout (``"{name}/{layer}": {"w": HWIO,
"b"}``) of numpy, JAX or torch arrays. Stacked with a leading member axis K
(the JAX tool's ``vmap`` over ensemble members, x shared), the result is
[K, N, H, W, Cout]. ``block_weights`` carries such parameters across into
the kernel's layout once; ``fused_inception`` also takes its result, so a
caller that runs a block many times converts once.

Precondition: x >= 0. Every block input is a concat of ReLU outputs and
pools of them, and the kernel's MAX pool pads with zeros where Caffe pads
with -inf; the two agree only on such inputs.

A CUDA tensor launches the kernel, or raises: one C call (counted once in
``LAUNCHES``) of three device launches in bf16 (the x-tile GEMMs with the
pool, then the 3x3 convs) or five in f32, through ``kernels/_launch.py``. A
CPU tensor takes the plain PyTorch version beside it
(``fused_inception_reference``: F.conv2d in f32, the port's Caffe pooling
and torch.cat). No stride-2 block and no block without a pool projection
(BN-Inception's stride-1 blocks all have one) runs on the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from videoquery_torch.kernels import _launch
from videoquery_torch.nn import bn_inception as bi

# kernel launches (C calls) since import (or since a caller reset it)
LAUNCHES = 0

# x, bf16, n, h, w, cin, members, c1, r3, c3, rd, d1, d2, pp, pool_max, 10
# weight and bias pointers, red, dd1, out (the stream follows)
_ENTRY = _launch.Entry("inception_block.cu", "vq_inception_block", 28)
DEVICE_LAUNCHES = {torch.bfloat16: 3, torch.float32: 5}


@dataclasses.dataclass
class BlockWeights:
    """One block's weights in the kernel's layout: conv weights [K, cout,
    taps * cin] (taps row-major, then input channels: the HWIO order) in the
    activation dtype, f32 biases [K, cout]. ``w1``/``b1`` concatenate the
    three 1x1 convs that read x (1x1, 3x3_reduce, double_3x3_reduce)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    wd1: torch.Tensor
    bd1: torch.Tensor
    wd2: torch.Tensor
    bd2: torch.Tensor
    wpp: torch.Tensor | None
    bpp: torch.Tensor | None
    stacked: bool            # the parameters had a leading member axis

    @property
    def members(self) -> int:
        return self.w1.shape[0]


def _gemm_layout(w: torch.Tensor) -> torch.Tensor:
    """HWIO [K, kh, kw, cin, cout] -> [K, cout, kh * kw * cin]."""
    k, kh, kw, cin, cout = w.shape
    return w.permute(0, 4, 1, 2, 3).reshape(k, cout, kh * kw * cin)


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().float()
    return torch.from_numpy(np.asarray(a, np.float32))


def block_weights(params: Mapping, name: str, spec: Mapping, dtype: torch.dtype,
                  device) -> BlockWeights:
    """The block's parameters ({"{name}/{layer}": {"w": HWIO [K?, kh, kw,
    cin, cout], "b": [K?, cout]}} of numpy, JAX or torch arrays) in the
    kernel's layout on ``device``; weights in ``dtype`` (rounded to nearest
    even from f32), biases f32."""
    stacked = _f32(params[f"{name}/3x3"]["w"]).dim() == 5

    def wb(layer):
        p = params[f"{name}/{layer}"]
        w, b = _f32(p["w"]).to(device), _f32(p["b"]).to(device)
        if not stacked:
            w, b = w[None], b[None]
        return _gemm_layout(w), b

    reads_x = (["1x1"] if spec["c1"] else []) + ["3x3_reduce", "double_3x3_reduce"]
    pairs = [wb(layer) for layer in reads_x]
    out = {"w1": torch.cat([w for w, _ in pairs], dim=1).to(dtype).contiguous(),
           "b1": torch.cat([b for _, b in pairs], dim=1).contiguous()}
    for key, layer in (("3", "3x3"), ("d1", "double_3x3_1"), ("d2", "double_3x3_2")):
        w, b = wb(layer)
        out[f"w{key}"], out[f"b{key}"] = w.to(dtype).contiguous(), b.contiguous()
    out["wpp"] = out["bpp"] = None
    if spec["pp"]:
        w, b = wb("pool_proj")
        out["wpp"], out["bpp"] = w.to(dtype).contiguous(), b.contiguous()
    return BlockWeights(stacked=stacked, **out)


def _weights(params, name, spec, x) -> BlockWeights:
    if spec["stride"] != 1:
        raise ValueError(f"{name}: only stride-1 blocks are fused (stride {spec['stride']})")
    wts = (params if isinstance(params, BlockWeights)
           else block_weights(params, name, spec, x.dtype, x.device))
    if wts.w1.dtype != x.dtype or wts.w1.device != x.device:
        raise ValueError(f"weights are {wts.w1.dtype} on {wts.w1.device}; x is "
                         f"{x.dtype} on {x.device}")
    return wts


def _oihw(w: torch.Tensor, k: int) -> torch.Tensor:
    """[cout, k*k*cin] (HWIO order) -> OIHW [cout, cin, k, k], as f32."""
    cout = w.shape[0]
    return w.float().reshape(cout, k, k, -1).permute(0, 3, 1, 2)


def fused_inception_reference(params, name: str, spec: Mapping,
                              x: torch.Tensor) -> torch.Tensor:
    """Plain version: each conv is F.conv2d in f32 on the working-type
    values (exact products, f32 sums), + f32 bias, ReLU, cast; AVE pool an
    f32 sum / 9 then a cast, as the fused kernel does. On the card, turn
    TF32 off first (torch.backends.cudnn.allow_tf32)."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [N, H, W, C]; got {tuple(x.shape)}")
    wts = _weights(params, name, spec, x)
    dt = x.dtype
    c1, r3 = spec["c1"], spec["r3"]
    xf = x.permute(0, 3, 1, 2).float()                      # NCHW, exact

    def conv(inp, w, b, k):
        y = F.conv2d(inp.float(), _oihw(w, k), b, padding=k // 2)
        return torch.relu(y).to(dt)

    if spec["pool"] == "ave":
        pool = bi.avg_pool(xf, 3, 1, 1).to(dt)              # f32 sum, /9, cast
    else:
        pool = bi.max_pool(x.permute(0, 3, 1, 2), 3, 1, 1)   # exact in any type
    outs = []
    for m in range(wts.members):
        w1, b1 = wts.w1[m], wts.b1[m]
        branches = []
        if c1:
            branches.append(conv(xf, w1[:c1], b1[:c1], 1))
        r = conv(xf, w1[c1:c1 + r3], b1[c1:c1 + r3], 1)
        branches.append(conv(r, wts.w3[m], wts.b3[m], 3))
        d = conv(xf, w1[c1 + r3:], b1[c1 + r3:], 1)
        d = conv(d, wts.wd1[m], wts.bd1[m], 3)
        branches.append(conv(d, wts.wd2[m], wts.bd2[m], 3))
        branches.append(conv(pool, wts.wpp[m], wts.bpp[m], 1)
                        if wts.wpp is not None else pool)
        outs.append(torch.cat(branches, dim=1).permute(0, 2, 3, 1))
    out = torch.stack(outs)
    return out if wts.stacked else out[0]


# -- the kernel ---------------------------------------------------------------

def fused_inception(params, name: str, spec: Mapping, x: torch.Tensor) -> torch.Tensor:
    """One stride-1 inception block of NHWC x (>= 0; f32 or bf16), fused:
    [N, H, W, Cout], or [K, N, H, W, Cout] for stacked parameters."""
    global LAUNCHES
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16 NHWC; got {x.dtype} "
                         f"{tuple(x.shape)}")
    wts = _weights(params, name, spec, x)
    n, h, w, cin = x.shape
    if wts.w1.shape[2] != cin:
        raise ValueError(f"{name}: weights take {wts.w1.shape[2]} channels; x has {cin}")
    if x.device.type == "cpu":
        return fused_inception_reference(wts, name, spec, x)
    if x.device.type != "cuda":
        raise ValueError(f"T1 runs on CUDA or (plain version) the CPU, not {x.device}")
    c1, r3, c3, rd, d1, d2, pp = (spec[k] for k in ("c1", "r3", "c3", "rd", "d1", "d2", "pp"))
    if not pp:
        raise ValueError(f"{name}: the kernel needs a pool projection (pp > 0)")
    if any(c % 8 for c in (cin, c1, r3, c3, rd, d1, d2, pp)):
        raise ValueError(f"{name}: T1 takes channel counts that are multiples of 8")
    tensors = [x, wts.w1, wts.b1, wts.w3, wts.b3, wts.wd1, wts.bd1, wts.wd2, wts.bd2,
               wts.wpp, wts.bpp]
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("T1 operands must be contiguous and 16-byte aligned")
    k = wts.members
    p = n * h * w
    cout = c1 + c3 + d2 + pp
    if k * p * max(cout, r3 + rd, cin) >= 2 ** 31:
        raise ValueError("T1 takes fewer than 2**31 elements per operand")
    rows = p
    if x.dtype == torch.bfloat16:
        # the 3x3 convs read r3, rd and d1 zero-bordered: [N, H + 2, W + 2]
        rows = n * (h + 2) * (w + 2)
        if any(c % 32 for c in (r3, rd, d1)) or rows > 65535 * 256 or w > 128:
            raise ValueError(f"{name}: T1's bf16 body takes r3, rd and d1 in multiples "
                             "of 32, at most 65535 * 256 padded pixels and rows of at "
                             "most 128 pixels (the halos in shared memory)")
    out = torch.empty((k, n, h, w, cout), dtype=x.dtype, device=x.device)
    red = torch.empty((k, rows, r3 + rd), dtype=x.dtype, device=x.device)
    dd1 = torch.empty((k, rows, d1), dtype=x.dtype, device=x.device)
    _launch.launch(_ENTRY, "T1", x.get_device(), x.data_ptr(), int(x.dtype == torch.bfloat16),
                   n, h, w, cin, k, c1, r3, c3, rd, d1, d2, pp, int(spec["pool"] == "max"),
                   *(t.data_ptr() for t in tensors[1:]), red.data_ptr(), dd1.data_ptr(),
                   out.data_ptr())
    LAUNCHES += 1
    return out if wts.stacked else out[0]
