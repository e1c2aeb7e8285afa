"""Python-side utilities (counterpart of `soillib_tpu/util.py`):
`zip_save` / `zip_load` and `relief_shade`. The matplotlib plotting
helpers of the JAX package are not ported.
"""

from __future__ import annotations

import numpy as np

from soillib_tpu_torch.io.checkpoint import zip_load, zip_save  # re-export
from soillib_tpu_torch.io.tiff import _host

__all__ = ["zip_save", "zip_load", "relief_shade"]


def relief_shade(h, n):
    """Diffuse hillshade (numpy) from a height field and its (W, H, 3)
    normals, arrays or tensors on any device."""
    h = _host(h)
    n = _host(n)
    h_min = np.nanmin(h)
    h_max = np.nanmax(h)
    h = (h - h_min) / (h_max - h_min) if h_max > h_min else np.zeros_like(h)

    light = np.array([-1.0, 2.0, 1.0])
    light = light / np.linalg.norm(light)
    diffuse = np.sum(light * n, axis=-1)

    flattone = np.full(h.shape, 0.75)
    weight = 1.0
    return weight * diffuse + (1.0 - weight) * flattone
