"""K2: one TV-L1 pyramid level for a batch of pairs (``csrc/tvl1_level.cu``).

Port of ``videoquery/kernels/tvl1_pallas.py::tvl1_level_pallas``. For each
of ``p.n_warps`` warps: clamp the flow to +-max_disp, warp I1, linearise,
then ``p.n_iters`` primal-dual steps (the update equations of
``kernels/tvl1._tvl1_level``, with the soft threshold as one clip).

The port computes what the TPU kernel computes, on its domain: planes are
edge-padded to multiples of (8, 128) and the iteration runs on the whole
padded domain (its borders sit at the padded edge), and I1 is the window
image padded by max_disp+1 and read modulo its padded size, as the TPU
kernel's circular ``pltpu.roll`` reads it (at widths 64 and below the right
columns of the padded domain see wrapped-around image columns).

Warp modes, as in the TPU kernel: ``grad_source="warped"`` with
``separable_warp`` (production) warps only I1 and differentiates the warped
image; ``"image"`` with ``separable_warp`` warps I1 and its centred
gradients; ``separable_warp=False`` is the full 4-tap warp of all three.

``tvl1_level`` is the wrapper. A CUDA tensor launches the kernel (one C call
per level, through ``kernels/_launch.py``), or raises; a CPU tensor takes
the plain PyTorch version beside it (``tvl1_level_reference``).
``LAUNCHES`` counts C calls. ``level_plan`` chooses, from the shape alone,
how a call runs: the "band" route is one device launch per level, the whole
level of a pair in the shared memory of one thread-block cluster, for
padded widths of 128 (every production level); other shapes (wider or
taller grids) take the "tiles" route, a few launches per warp and one per
primal-dual iteration with the state in device memory.
``LevelPlan.device_launches`` gives the device launches of a call.
"""

from __future__ import annotations

import dataclasses
import functools
import re

import numpy as np
import torch

from videoquery_torch.kernels import _launch
from videoquery_torch.kernels.tvl1 import TVL1Params
from videoquery_torch.kernels.window_warp import (PaddedGeometry, edge_pad,
                                                  full_warp, hpass, vpass)

# kernel launches (C calls, one per level) since import, or since a reset
LAUNCHES = 0
# K2's device kernels (the band route's, the tiles route's per-step ones) as
# torch.profiler names them ("void " before a template's name only)
DEVICE_KERNELS = re.compile(r"^(?:void )?\(anonymous namespace\)::(tvl1_band_kernel|pad_kernel|"
                            r"crop_kernel|clamp_kernel|vpass_kernel|hpass_kernel|full_kernel|"
                            r"grad_kernel|lin_kernel|pd_kernel)\b")

_SOURCE = "tvl1_level.cu"
MODE_WARPED, MODE_IMAGE, MODE_FULL = 0, 1, 2


def warp_mode(p: TVL1Params) -> int:
    if not p.separable_warp:
        return MODE_FULL
    return MODE_WARPED if p.grad_source == "warped" else MODE_IMAGE


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak constant."""
    return float(np.float32(x))


def _constants(p: TVL1Params) -> tuple[float, float, float, float]:
    return (_f32(p.lambda_ * p.theta), _f32(p.tau / p.theta), _f32(p.theta),
            _f32(p.grad_eps))


def centered_grad(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Centred spatial gradients of [N, H, W], one-sided at the borders
    (tvl1_pallas._centered_grad_batch)."""
    gx = (torch.cat([img[:, :, 1:], img[:, :, -1:]], 2)
          - torch.cat([img[:, :, :1], img[:, :, :-1]], 2))
    gy = (torch.cat([img[:, 1:], img[:, -1:]], 1)
          - torch.cat([img[:, :1], img[:, :-1]], 1))
    h, w = img.shape[1:]
    col = torch.arange(w, device=img.device)
    row = torch.arange(h, device=img.device)[:, None]
    gx = torch.where((col > 0) & (col < w - 1), gx * 0.5, gx)
    gy = torch.where((row > 0) & (row < h - 1), gy * 0.5, gy)
    return gx, gy


# -- plain PyTorch version ----------------------------------------------------

def _forward_diff(f):
    z = torch.zeros_like(f)
    fx = torch.cat([f[..., 1:] - f[..., :-1], z[..., :1]], -1)
    fy = torch.cat([f[..., 1:, :] - f[..., :-1, :], z[..., :1, :]], -2)
    return fx, fy


def _divergence(p1, p2):
    d1 = torch.cat([p1[..., :1], p1[..., 1:-1] - p1[..., :-2],
                    -p1[..., -2:-1]], -1)
    d2 = torch.cat([p2[..., :1, :], p2[..., 1:-1, :] - p2[..., :-2, :],
                    -p2[..., -2:-1, :]], -2)
    return d1 + d2


def _grad_padded(x):
    """Centred differences with one-sided borders over the whole padded
    plane (the TPU kernel's _grad_inkernel)."""
    xr = torch.roll(x, -1, 2)
    xl = torch.roll(x, 1, 2)
    col = torch.arange(x.shape[2], device=x.device)
    gx = torch.where(col == 0, xr - x,
                     torch.where(col == x.shape[2] - 1, x - xl, (xr - xl) * 0.5))
    xd = torch.roll(x, -1, 1)
    xu = torch.roll(x, 1, 1)
    row = torch.arange(x.shape[1], device=x.device)[:, None]
    gy = torch.where(row == 0, xd - x,
                     torch.where(row == x.shape[1] - 1, x - xu, (xd - xu) * 0.5))
    return gx, gy


def tvl1_level_reference(i0, i1, u, v, p: TVL1Params = TVL1Params(),
                         max_disp: int = 6):
    """Plain version of tvl1_level (same arguments and results)."""
    n, h, w = i0.shape
    d = max_disp
    g = PaddedGeometry(h, w, d)
    mode = warp_mode(p)
    l_t, taut, theta, eps = _constants(p)
    i0p = edge_pad(i0, g.hp, g.wp)
    up = edge_pad(u, g.hp, g.wp)
    vp = edge_pad(v, g.hp, g.wp)
    wins = [edge_pad(i1, g.hh, g.ww, g.pad, g.pad)]
    if mode != MODE_WARPED:
        wins += [edge_pad(x, g.hh, g.ww, g.pad, g.pad) for x in centered_grad(i1)]
    q11 = torch.zeros_like(up)
    q12, q21, q22 = (torch.zeros_like(up) for _ in range(3))
    for _warp in range(p.n_warps):
        up = up.clamp(-d, d)
        vp = vp.clamp(-d, d)
        if mode == MODE_FULL:
            i1w, ix, iy = (full_warp(x, up, vp, d) for x in wins)
        elif mode == MODE_IMAGE:
            i1w, ix, iy = (hpass(vpass(x, vp, d), up, d) for x in wins)
        else:
            i1w = hpass(vpass(wins[0], vp, d), up, d)
            ix, iy = _grad_padded(i1w)
        grad = ix * ix + iy * iy
        rho_c = i1w - ix * up - iy * vp - i0p
        rgrad = 1.0 / torch.clamp(grad, min=eps)
        for _ in range(p.n_iters):
            rho = rho_c + ix * up + iy * vp
            step = torch.clamp(-rho * rgrad, -l_t, l_t)
            u1 = up + step * ix
            v1 = vp + step * iy
            up = u1 + theta * _divergence(q11, q12)
            vp = v1 + theta * _divergence(q21, q22)
            ux, uy = _forward_diff(up)
            vx, vy = _forward_diff(vp)
            ru = 1.0 / (1.0 + taut * torch.sqrt(ux * ux + uy * uy))
            rv = 1.0 / (1.0 + taut * torch.sqrt(vx * vx + vy * vy))
            q11 = (q11 + taut * ux) * ru
            q12 = (q12 + taut * uy) * ru
            q21 = (q21 + taut * vx) * rv
            q22 = (q22 + taut * vy) * rv
    return up[:, :h, :w].contiguous(), vp[:, :h, :w].contiguous()


# -- the kernel ---------------------------------------------------------------

SMEM_BYTES = 232_448     # dynamic shared memory a block may use on sm_90
MAX_CLUSTER = 8          # the portable thread-block cluster size
BAND_ROWS = 16           # the band height that lets two bands share an SM
BAND_WIDTH = 128         # the padded width the band kernel is compiled for
BAND_PLANES = 10         # u, v, q11, q12, q21, q22, I1wx, I1wy, rho_c, rgrad
BAND_SMEM = BAND_PLANES * BAND_ROWS * BAND_WIDTH * 4
_TX, _TY = 32, 8         # the tiles route's primal-dual tile


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """How one K2 call runs, chosen from the shape alone (level_plan).

    route "band": one launch of tvl1_band_kernel, one cluster of ``cluster``
    blocks per pair, each holding ``rows`` padded rows of its pair's level
    state in ``smem`` bytes of shared memory; grid (cluster * n,). route
    "tiles": a launch per step and per primal-dual iteration, the state in
    device scratch; ``rows``, ``cluster`` and ``smem`` are 0 and grid is the
    primal-dual launch's (wp / 32, hp / 8, n)."""

    route: str
    rows: int
    cluster: int
    smem: int
    grid: tuple[int, ...]
    geo: PaddedGeometry
    n: int

    def device_launches(self, mode: int, n_warps: int, n_iters: int) -> int:
        """Device launches of one C call (memsets included)."""
        if self.n == 0:
            return 0
        if self.route == "band":
            return 1
        warp_step = 1 if mode == MODE_FULL else (3 if mode == MODE_WARPED else 2)
        # memset + pad, per warp clamp + warp passes + linearisation, the
        # primal-dual launches, the crop
        return 3 + n_warps * (2 + warp_step) + n_warps * n_iters

    def scratch_floats(self, mode: int) -> int:
        """Device scratch of one call (tiles route: 17 [n, hp, wp] planes and
        the vertical pass's [n, hp, ww] planes; none on the band route)."""
        if self.route == "band":
            return 0
        g = self.geo
        t_planes = {MODE_WARPED: 1, MODE_IMAGE: 3, MODE_FULL: 0}[mode]
        return self.n * g.hp * (17 * g.wp + t_planes * g.ww)


@functools.lru_cache(maxsize=256)
def level_plan(n: int, h: int, w: int, d: int) -> LevelPlan:
    """The plan of a K2 call on n pairs of [h, w] with window d.

    The band kernel is compiled for bands of BAND_ROWS rows of a padded
    width of BAND_WIDTH (every production level, w <= 128, and the rescue
    window): such a shape with hp within MAX_CLUSTER bands takes the band
    route, C = ceil(hp / BAND_ROWS). Any other shape (a wider grid, or a
    taller one) takes the tiles route."""
    g = PaddedGeometry(h, w, d)
    cluster = -(-g.hp // BAND_ROWS)
    if g.wp == BAND_WIDTH and cluster <= MAX_CLUSTER:
        return LevelPlan("band", BAND_ROWS, cluster, BAND_SMEM, (cluster * n,), g, n)
    return LevelPlan("tiles", 0, 0, 0, (-(-g.wp // _TX), -(-g.hp // _TY), n), g, n)


@functools.lru_cache(maxsize=64)
def _constant_bits(p: TVL1Params) -> tuple[int, int, int, int]:
    """_constants(p) as the bit patterns of their float32 values (the C
    entry's argument slots are integers)."""
    return tuple(int(np.float32(c).view(np.int32)) for c in _constants(p))


_ENTRY = _launch.Entry(_SOURCE, "vq_tvl1_level", 24)
_ROUTES = {"band": 0, "tiles": 1}


def _check(i0, i1, u, v, max_disp) -> None:
    if i0.dim() != 3 or i0.dtype != torch.float32:
        raise ValueError(f"i0 must be float32 [N, H, W]; got {i0.dtype} "
                         f"{tuple(i0.shape)}")
    for name, t in (("i1", i1), ("u", u), ("v", v)):
        if t.dtype != torch.float32 or t.shape != i0.shape:
            raise ValueError(f"{name} must be float32 {tuple(i0.shape)}; got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != i0.device:
            raise ValueError("i0, i1, u and v must be on one device")
    if max_disp < 1:
        raise ValueError(f"max_disp must be >= 1; got {max_disp}")


def tvl1_level(i0, i1, u, v, p: TVL1Params = TVL1Params(), max_disp: int = 6):
    """One TV-L1 level: i0, i1, u, v f32 [N, H, W] -> updated (u, v)."""
    global LAUNCHES
    _check(i0, i1, u, v, max_disp)
    if i0.device.type == "cpu":
        return tvl1_level_reference(i0, i1, u, v, p, max_disp)
    if i0.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or (plain version) the CPU, not {i0.device}")
    if not (i0.is_contiguous() and i1.is_contiguous()):
        raise ValueError("K2 operands must be contiguous")
    n, h, w = i0.shape
    plan = level_plan(n, h, w, max_disp)
    if n * plan.geo.hh * plan.geo.ww >= 2 ** 31:
        raise ValueError("K2 takes fewer than 2**31 padded pixels per launch")
    mode = warp_mode(p)
    u, v = u.contiguous(), v.contiguous()
    ix = iy = None
    if mode != MODE_WARPED:
        ix, iy = (t.contiguous() for t in centered_grad(i1))
    out = torch.empty((2, n, h, w), dtype=torch.float32, device=i0.device)
    scratch = None
    if plan.route == "tiles":
        scratch = torch.empty(plan.scratch_floats(mode), dtype=torch.float32,
                              device=i0.device)
    out_ptr = out.data_ptr()
    _launch.launch(
        _ENTRY, "K2", i0.get_device(), i0.data_ptr(), i1.data_ptr(),
        0 if ix is None else ix.data_ptr(), 0 if iy is None else iy.data_ptr(),
        u.data_ptr(), v.data_ptr(), out_ptr, out_ptr + n * h * w * 4,
        0 if scratch is None else scratch.data_ptr(),
        n, h, w, max_disp, mode, p.n_warps, p.n_iters, *_constant_bits(p),
        _ROUTES[plan.route], plan.rows, plan.cluster, plan.smem)
    LAUNCHES += 1
    return out[0], out[1]
