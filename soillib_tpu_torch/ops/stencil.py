"""Radius-1 shifts over 2-D fields (counterpart of
`soillib_tpu/ops/stencil.py`; only what the erosion step uses so far)."""

from __future__ import annotations

import torch.nn.functional as F


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
