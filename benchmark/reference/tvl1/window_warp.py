# A frozen copy of videoquery_torch/kernels/window_warp.py (its plain versions only), for the
# benchmark's reference; it imports nothing of the program.
"""The window warp, plain PyTorch: sample img [N, H, W] at (y + v, x + u)
with the flow clamped to +-d and edge-clamped borders. ``separable=True``
(production) is the factorized warp (a vertical 2-tap pass whose weights
come from v at the sampled column, then a horizontal 2-tap pass with u),
on the TPU kernels' padded domain, as the program computes it; the level
(``tvl1_level.py``) shares the passes."""

from __future__ import annotations

import dataclasses

import torch



def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PaddedGeometry:
    """The TPU kernels' domain for [h, w] planes and window d: plain planes
    padded to [hp, wp], window images to [hh, ww] with a margin of
    pad = d + 1 at the top and left (tvl1_pallas.py:321-337, :430-448)."""

    h: int
    w: int
    d: int

    @property
    def pad(self) -> int:
        return self.d + 1

    @property
    def hp(self) -> int:
        return round_up(self.h, 8)

    @property
    def wp(self) -> int:
        return round_up(self.w, 128)

    @property
    def hh(self) -> int:
        return round_up(self.h + 2 * self.pad, 8)

    @property
    def ww(self) -> int:
        return round_up(self.w + 2 * self.pad, 128)


def edge_pad(x: torch.Tensor, rows: int, cols: int, top: int = 0,
             left: int = 0) -> torch.Tensor:
    """[N, h, w] -> [N, rows, cols] with x placed at (top, left) and every
    other cell a copy of the nearest edge (jnp.pad mode="edge")."""
    h, w = x.shape[-2:]
    ri = (torch.arange(rows, device=x.device) - top).clamp(0, h - 1)
    ci = (torch.arange(cols, device=x.device) - left).clamp(0, w - 1)
    return x.index_select(-2, ri).index_select(-1, ci)


def _taps(f: torch.Tensor, d: int):
    """(k0, w0, w1): the two shifts k0 = floor(f), k0 + 1 whose triangle
    weights max(0, 1 - |f - k|) can be nonzero for |f| <= d, and those
    weights, computed by the TPU kernel's expression."""
    k0 = torch.floor(f).clamp(-d, d)
    w0 = torch.clamp(1.0 - (f - k0).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (f - (k0 + 1.0)).abs(), min=0.0)
    return k0.long(), w0, w1


def vpass(imgp: torch.Tensor, v: torch.Tensor, d: int) -> torch.Tensor:
    """Vertical pass of the separable warp over padded planes.

    imgp [N, hh, ww] (margin d+1), v [N, H, W] clamped to +-d ->
    t [N, H, ww]: t[y, X] = sum_k w_k(v_ext[y, X]) * imgp[(y + d+1 + k) % hh, X]
    with v_ext[y, X] = v[y, clamp(X - d - 1, 0, W - 1)]."""
    n, hh, ww = imgp.shape
    hgt, wid = v.shape[-2:]
    pad = d + 1
    cols = (torch.arange(ww, device=v.device) - pad).clamp(0, wid - 1)
    v_ext = v.index_select(-1, cols)
    k0, w0, w1 = _taps(v_ext, d)
    rows = (torch.arange(hgt, device=v.device)[None, :, None] + pad + k0) % hh
    return (w0 * torch.gather(imgp, 1, rows)
            + w1 * torch.gather(imgp, 1, (rows + 1) % hh))


def hpass(t: torch.Tensor, u: torch.Tensor, d: int) -> torch.Tensor:
    """Horizontal pass: t [N, H, ww], u [N, H, W] clamped -> [N, H, W],
    out[y, x] = sum_k w_k(u[y, x]) * t[y, (x + d+1 + k) % ww]."""
    ww = t.shape[-1]
    wid = u.shape[-1]
    k0, w0, w1 = _taps(u, d)
    cols = (torch.arange(wid, device=u.device) + d + 1 + k0) % ww
    return (w0 * torch.gather(t, 2, cols)
            + w1 * torch.gather(t, 2, (cols + 1) % ww))


def full_warp(imgp: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              d: int) -> torch.Tensor:
    """4-tap bilinear over padded planes (u, v clamped), summed in the TPU
    loop's order: (k0y, k0x), (k0y, k0x+1), (k0y+1, k0x), (k0y+1, k0x+1)."""
    n, hh, ww = imgp.shape
    hgt, wid = u.shape[-2:]
    pad = d + 1
    ky, wy0, wy1 = _taps(v, d)
    kx, wx0, wx1 = _taps(u, d)
    r0 = (torch.arange(hgt, device=u.device)[None, :, None] + pad + ky) % hh
    c0 = (torch.arange(wid, device=u.device)[None, None, :] + pad + kx) % ww
    flat = imgp.reshape(n, hh * ww)

    def at(r, c):
        return torch.gather(flat, 1, (r * ww + c).reshape(n, -1)).reshape(u.shape)

    r1, c1 = (r0 + 1) % hh, (c0 + 1) % ww
    acc = (wy0 * wx0) * at(r0, c0)
    acc = acc + (wy0 * wx1) * at(r0, c1)
    acc = acc + (wy1 * wx0) * at(r1, c0)
    return acc + (wy1 * wx1) * at(r1, c1)


def window_warp_reference(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          d: int = 4, separable: bool = True) -> torch.Tensor:
    """Plain version of window_warp, on the TPU kernel's padded domain."""
    n, h, w = img.shape
    g = PaddedGeometry(h, w, d)
    imgp = edge_pad(img, g.hh, g.ww, g.pad, g.pad)
    up = edge_pad(u.clamp(-d, d), g.hp, g.wp)
    vp = edge_pad(v.clamp(-d, d), g.hp, g.wp)
    if separable:
        out = hpass(vpass(imgp, vp, d), up, d)
    else:
        out = full_warp(imgp, up, vp, d)
    return out[:, :h, :w]


def window_warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                d: int = 4, separable: bool = True) -> torch.Tensor:
    """Batched window warp f32 [N, H, W]; flow clamped to +-d (the plain
    version)."""
    return window_warp_reference(img, u, v, d, separable)
