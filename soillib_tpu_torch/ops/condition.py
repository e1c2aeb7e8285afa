"""Hydrological DEM conditioning (counterpart of
`soillib_tpu/ops/condition.py`; reference workload: dem_condition.py).

The Planchon–Darboux "flooding" fill as an iterated D4/D8 min-stencil:

    W0 = +inf everywhere except boundary cells (= h there)
    W  <- max(h, min(W, min_k(W_k + eps_k)))     until fixed point

which fills every closed depression to its spill level plus a tiny
epsilon gradient, so flow directions resolve across the filled flats (the
role of pysheds' resolve_flats). Plain torch, as in the JAX package (no
kernel of its own): each sweep is a few elementwise passes.

The JAX loop tests for a change after every sweep; here the test runs
every BLOCK sweeps (one host read each). Past the fixed point a sweep
changes nothing, so the result is the same.
"""

from __future__ import annotations

import math

import torch

from soillib_tpu_torch.core.device import as_field
from soillib_tpu_torch.core.grid import D8, shift_lengths, shifts_for
from soillib_tpu_torch.ops.graph_sweep import BLOCK, changed
from soillib_tpu_torch.ops.stencil import _shift


def fill_depressions(height, edge: int = D8, eps: float = 1e-4,
                     max_iters: int = None, device=None):
    """Fill closed depressions to their spill level (Planchon–Darboux).

    Args:
      height: (W, H) DEM; NaN cells are data holes that drain freely
        (they act as boundaries, like pysheds' nodata).
      edge: D4 or D8 connectivity.
      eps: per-unit-distance epsilon gradient imposed on filled flats.
      max_iters: hard bound on sweeps (default W*H, the true worst case;
        the convergence test exits far earlier in practice).

    Returns:
      (W, H) conditioned DEM, >= height everywhere, equal outside
      depressions. Floating dtypes are kept (float64 in, float64 out).
    """
    h = as_field(height, device, dtype=None)
    if not torch.is_floating_point(h):
        h = h.to(torch.float32)
    W, H = h.shape
    shifts = shifts_for(edge)
    lens = shift_lengths(edge)
    if max_iters is None:
        max_iters = W * H

    hole = torch.isnan(h)
    hs = torch.where(hole, -math.inf, h)

    x = torch.arange(W, device=h.device)[:, None]
    y = torch.arange(H, device=h.device)[None, :]
    boundary = (x == 0) | (x == W - 1) | (y == 0) | (y == H - 1)
    # Cells next to a hole spill into it like a boundary.
    near_hole = torch.zeros_like(hole)
    for dx, dy in shifts:
        near_hole = near_hole | _shift(hole, int(dx), int(dy), False)
    seed = boundary | near_hole | hole

    w = torch.where(seed, hs, math.inf)

    def lower(w):
        best = torch.full_like(w, math.inf)
        for (dx, dy), L in zip(shifts, lens):
            wn = _shift(w, int(dx), int(dy), math.inf)
            best = torch.minimum(best, wn + eps * float(L))
        return torch.maximum(hs, torch.minimum(w, best))

    it = 0
    while it < max_iters:
        prev = w
        for _ in range(min(BLOCK, max_iters - it)):
            w = lower(w)
        it += BLOCK
        if not bool(changed(w, prev)):
            break
    return torch.where(hole, math.nan, w)


def condition(height, edge: int = D8, eps: float = 1e-4, device=None):
    """Full conditioning pipeline: depression filling + flat resolution
    (both handled by the epsilon-graded Planchon–Darboux fill). Mirrors
    the pysheds sequence the reference uses (dem_condition.py:32-41)."""
    return fill_depressions(height, edge, eps, device=device)
