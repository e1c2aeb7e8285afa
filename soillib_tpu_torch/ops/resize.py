"""Bilinear rescale and world-space blit (counterpart of
`soillib_tpu/ops/resize.py`).

These cover the legacy silt surface used by the multiscale and merge
examples: `soil.resize(src, newres)` (erosion_gpu_multiscale.py:112-137)
and `soil.copy(dst, src, gmin, gmax, gscale, wmin, wmax, wscale, pscale)`
(tiff_merge.py:67), as functions that return new tensors.

The sample coordinates are computed in float32 with each Python scale
rounded to float32, as `jnp` computes with a weakly typed scalar: a
float64 coordinate would move the bilinear weights by an ulp. Divisions
by a scale divide by a 0-dim tensor (`_div`), because on the card a
tensor divided by a Python number is multiplied by its reciprocal, which
rounds twice.
"""

from __future__ import annotations

import math

import torch

from soillib_tpu_torch.core.device import as_field
from soillib_tpu_torch.ops.noise import _div


def _bilinear_sample(src, xs, ys, fill=math.nan):
    """Bilinear sample of (W, H[, C]) `src` at float coords (xs, ys)
    (tensors of one shape); clamps to edge, `fill` where fully out of
    range."""
    W, H = src.shape[0], src.shape[1]
    oob = (xs < -0.5) | (ys < -0.5) | (xs > W - 0.5) | (ys > H - 0.5)
    x0 = torch.clamp(torch.floor(xs).to(torch.int32), 0, W - 1)
    y0 = torch.clamp(torch.floor(ys).to(torch.int32), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    if src.dim() == 3:
        wx = wx[..., None]
        wy = wy[..., None]
        oob = oob[..., None]
    x0, y0, x1, y1 = x0.long(), y0.long(), x1.long(), y1.long()
    v00 = src[x0, y0]
    v01 = src[x0, y1]
    v10 = src[x1, y0]
    v11 = src[x1, y1]
    val = (
        v00 * (1 - wx) * (1 - wy)
        + v01 * (1 - wx) * wy
        + v10 * wx * (1 - wy)
        + v11 * wx * wy
    )
    return torch.where(oob, torch.full((), fill, dtype=val.dtype,
                                       device=val.device), val)


def resize(src, newres, device=None):
    """Bilinear rescale of a (W, H[, C]) field to (newres[0], newres[1][, C]).

    Uses half-pixel-center mapping: dst pixel i samples the source at
    (i + 0.5) * old/new - 0.5.
    """
    src = as_field(src, device)
    nW, nH = int(newres[0]), int(newres[1])
    W, H = src.shape[0], src.shape[1]
    dev = src.device
    xs = (torch.arange(nW, dtype=torch.float32, device=dev) + 0.5) \
        * (W / nW) - 0.5
    ys = (torch.arange(nH, dtype=torch.float32, device=dev) + 0.5) \
        * (H / nH) - 0.5
    xg = torch.clamp(xs, 0.0, W - 1.0)[:, None].expand(nW, nH)
    yg = torch.clamp(ys, 0.0, H - 1.0)[None, :].expand(nW, nH)
    return _bilinear_sample(src, xg, yg)


def copy(dst, src, gmin, gmax, gscale, wmin, wmax, wscale, pscale,
         device=None):
    """World-space blit: paint `src` (world extent [gmin, gmax], pixel
    scale gscale) into `dst` (world extent [wmin, wmax], pixel scale
    wscale, resolution additionally scaled by pscale). Cells of dst
    outside src's extent, or where src is NaN, are left untouched.
    Returns the updated dst (a new tensor on dst's device).

    This reconstructs the legacy silt `soil.copy` used by tiff_merge.py:67.
    """
    dst = as_field(dst, device)
    src = as_field(src, dst.device).to(dst.device)
    W, H = dst.shape[0], dst.shape[1]
    dev = dst.device

    # World position of each dst pixel center.
    xs = float(wmin[0]) + (torch.arange(W, dtype=torch.float32, device=dev)
                           + 0.5) * (float(wscale[0]) / pscale)
    ys = float(wmin[1]) + (torch.arange(H, dtype=torch.float32, device=dev)
                           + 0.5) * (float(wscale[1]) / pscale)
    xg = xs[:, None].expand(W, H)
    yg = ys[None, :].expand(W, H)

    # Source pixel coordinates for those world positions.
    sx = _div(xg - float(gmin[0]), float(gscale[0])) - 0.5
    sy = _div(yg - float(gmin[1]), float(gscale[1])) - 0.5
    sampled = _bilinear_sample(src, sx, sy, fill=math.nan)

    inside = (
        (xg >= float(gmin[0])) & (xg <= float(gmax[0]))
        & (yg >= float(gmin[1])) & (yg <= float(gmax[1]))
        & ~torch.isnan(sampled)
    )
    return torch.where(inside, sampled, dst)
