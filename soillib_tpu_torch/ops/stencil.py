"""Radius-1 stencils over 2-D fields (counterpart of
`soillib_tpu/ops/stencil.py`).

Plain torch: each operator is a few shifted reads and elementwise work,
memory-bound and without a kernel of its own in the JAX package either.
Boundary semantics are the reference's:
  * gradient:  central difference; where a neighbor is missing, fall back
    to the available one-sided difference, then 0 (grad.cu:62-71).
  * negslope:  per-axis max of *positive* one-sided downhill slopes,
    ignoring missing neighbors; magnitude of (gx, gy) (grad.cu:119-129).
  * laplacian: 9-point = 1/2 * (4-neighbor) + 1/2 * (diagonal, half-weight)
    with clamp-to-edge continuation (grad.cu:163-181).
  * normal:    normalize(-gx, -gy, 1) from a central-difference gradient
    with clamp-to-edge boundaries (op/normal.hpp:29-34).

Functions take a tensor (kept on its device) or an array-like, which goes
to `device`: the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from soillib_tpu_torch.core.device import as_field


def _shift(h, dx: int, dy: int, fill):
    """h shifted so result[x, y] = h[x + dx, y + dy]; out-of-range -> fill.

    Works for (W, H) and (W, H, C) tensors (the shift applies to the first
    two dims). `F.pad` takes its pads last dim first, where `jnp.pad`
    takes them first dim first."""
    pads = []
    for _ in range(h.dim() - 2):
        pads += [0, 0]
    pads += [max(0, -dy), max(0, dy), max(0, -dx), max(0, dx)]
    hp = F.pad(h, pads, value=fill)
    W, H = h.shape[0], h.shape[1]
    x0 = max(0, -dx) + dx
    y0 = max(0, -dy) + dy
    return hp[x0:x0 + W, y0:y0 + H, ...]


def _shift_edge(h, dx: int, dy: int):
    """Shift with clamp-to-edge (the reference's boundary continuation)."""
    W, H = h.shape[0], h.shape[1]
    xi = torch.clamp(torch.arange(W, device=h.device) + dx, 0, W - 1)
    yi = torch.clamp(torch.arange(H, device=h.device) + dy, 0, H - 1)
    return h[xi][:, yi, ...]


def _nan_neighbors(h):
    """The four axis neighbors of h, NaN outside the domain:
    (x-1, x+1, y-1, y+1)."""
    return (_shift(h, -1, 0, math.nan), _shift(h, +1, 0, math.nan),
            _shift(h, 0, -1, math.nan), _shift(h, 0, +1, math.nan))


def gradient(tensor, scale, device=None):
    """Central-difference gradient with one-sided boundary fallback.

    Args:
      tensor: (W, H) height field.
      scale: (sx, sy) cell widths.
    Returns:
      (W, H, 2) gradient field. Ref: grad.cu:22-97.
    """
    h = as_field(tensor, device)
    sx, sy = float(scale[0]), float(scale[1])
    hn0, hp0, h0n, h0p = _nan_neighbors(h)

    gxn = (h - hn0) / sx
    gxp = (hp0 - h) / sx
    gyn = (h - h0n) / sy
    gyp = (h0p - h) / sy

    gx = 0.5 * (hp0 - hn0) / sx
    gy = 0.5 * (h0p - h0n) / sy

    # NaN fallback chain: central -> backward -> forward -> 0 (grad.cu:65-71).
    gx = torch.where(torch.isnan(gx), gxn, gx)
    gx = torch.where(torch.isnan(gx), gxp, gx)
    gx = torch.where(torch.isnan(gx), 0.0, gx)
    gy = torch.where(torch.isnan(gy), gyn, gy)
    gy = torch.where(torch.isnan(gy), gyp, gy)
    gy = torch.where(torch.isnan(gy), 0.0, gy)

    return torch.stack([gx, gy], dim=-1)


def negslope(tensor, scale, device=None):
    """'Safe negative slope': norm of per-axis max downhill one-sided
    slopes. Zero in pits; boundaries contribute nothing.
    Ref: grad.cu:101-141."""
    h = as_field(tensor, device)
    sx, sy = float(scale[0]), float(scale[1])
    hn0, hp0, h0n, h0p = _nan_neighbors(h)

    gx = torch.zeros_like(h)
    gx = torch.where(~torch.isnan(hn0), torch.maximum(gx, (h - hn0) / sx), gx)
    gx = torch.where(~torch.isnan(hp0), torch.maximum(gx, (h - hp0) / sx), gx)
    gy = torch.zeros_like(h)
    gy = torch.where(~torch.isnan(h0n), torch.maximum(gy, (h - h0n) / sy), gy)
    gy = torch.where(~torch.isnan(h0p), torch.maximum(gy, (h - h0p) / sy), gy)

    return torch.sqrt(gx * gx + gy * gy)


def laplacian(tensor, scale, device=None):
    """9-point Laplacian with clamp-to-edge boundary continuation, on
    (W, H) or (W, H, C). Ref: grad.cu:147-206."""
    v = as_field(tensor, device)
    sx, sy = float(scale[0]), float(scale[1])
    hx = 1.0 / (sx * sx)
    hy = 1.0 / (sy * sy)

    v00 = v
    vn0 = _shift_edge(v, -1, 0)
    vp0 = _shift_edge(v, +1, 0)
    v0n = _shift_edge(v, 0, -1)
    v0p = _shift_edge(v, 0, +1)
    vnn = _shift_edge(v, -1, -1)
    vpp = _shift_edge(v, +1, +1)
    vpn = _shift_edge(v, +1, -1)
    vnp = _shift_edge(v, -1, +1)

    LH = ((vn0 - v00) * hx + (vp0 - v00) * hx + (v0n - v00) * hy
          + (v0p - v00) * hy)
    LD = (
        0.5 * (vnn - v00) * hx
        + 0.5 * (vpp - v00) * hx
        + 0.5 * (vpn - v00) * hy
        + 0.5 * (vnp - v00) * hy
    )
    return 0.5 * LH + 0.5 * LD


def normal(tensor, scale=(1.0, 1.0, 1.0), device=None):
    """Surface normal normalize(-gx, -gy, 1) from the height gradient:
    a central difference with clamp-to-edge boundaries, height scaled by
    scale.z and cell widths scale.x/y (op/normal.hpp:29-34).
    Returns (W, H, 3) unit normals."""
    h = as_field(tensor, device)
    sx, sy = float(scale[0]), float(scale[1])
    sz = float(scale[2]) if len(scale) > 2 else 1.0
    hn0 = _shift_edge(h, -1, 0)
    hp0 = _shift_edge(h, +1, 0)
    h0n = _shift_edge(h, 0, -1)
    h0p = _shift_edge(h, 0, +1)
    gx = 0.5 * (hp0 - hn0) * sz / sx
    gy = 0.5 * (h0p - h0n) * sz / sy
    n = torch.stack([-gx, -gy, torch.ones_like(gx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
