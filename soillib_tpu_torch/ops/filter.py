"""Filter operators (counterpart of `soillib_tpu/ops/filter.py`; reference:
model/filter/filter.cu).

`gaussian_blur` reproduces the reference's separable 2-pass blur with a
fixed +-16-tap window, clamp-to-edge sampling, and the truncated but
unrenormalised kernel (each tap weighted exp(-k^2/2 sigma^2)/(sqrt(2 pi)
sigma), filter.cu:47-48): for a large sigma the truncation loses mass.
This is reproduced, not fixed.

The JAX package leaves this to XLA (no Pallas kernel), so plain torch is
its port. Each pass sums its 33 weighted taps in the JAX package's order,
k = -16 ... 16, from slices of one edge-clamped copy of the field (a
`conv1d` would reorder the sum).
"""

from __future__ import annotations

import math

import torch

from soillib_tpu_torch.core.device import as_field

_KWINDOW = 16  # fixed window half-width (filter.cu:34)


def _blur_axis(v, sigma: float, axis: int):
    Z = math.sqrt(2.0 * math.pi) * sigma
    n = v.shape[axis]
    idx = torch.arange(-_KWINDOW, n + _KWINDOW, device=v.device)
    padded = v.index_select(axis, torch.clamp(idx, 0, n - 1))
    out = torch.zeros_like(v)
    for k in range(-_KWINDOW, _KWINDOW + 1):
        w = math.exp(-0.5 * (k / sigma) * (k / sigma)) / Z
        out = out + w * padded.narrow(axis, k + _KWINDOW, n)
    return out


def gaussian_blur(tensor, sigma: float, device=None):
    """Separable Gaussian blur, x-pass then y-pass. (W, H) or (W, H, C)."""
    v = as_field(tensor, device)
    v = _blur_axis(v, float(sigma), axis=0)
    v = _blur_axis(v, float(sigma), axis=1)
    return v
