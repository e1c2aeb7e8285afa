"""Per-step scalar diagnostics (counterpart of `soillib_tpu/core/metrics.py`).

The reference's only metric is wall time (`soil.timer`). These add the
physically meaningful invariants worth watching in long runs: reductions
over the state that return 0-dim tensors on the state's device, with no
host read, so folding them into a loop of steps does not synchronise it.
"""

from __future__ import annotations

import torch

from soillib_tpu_torch.models.erosion import godunov_gradient, merged_height


def mass_totals(state, scale):
    """Total bedrock / sediment / suspended / debris volume [length^3]."""
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    A = sx * sy
    return {
        "bedrock": torch.sum(state.layers[0]) * sz * A,
        "sediment": torch.sum(state.layers[1]) * sz * A,
        "suspended": torch.sum(state.mass) * A,
        "debris": torch.sum(state.debris) * A,
        "water": torch.sum(state.discharge) * A,
    }


def max_slope(state, scale, exit_slope: float = 0.0):
    """Steepest Godunov slope magnitude [m/m], the stability-relevant one
    (the transfer clamps scale with it, erosion.cu:527)."""
    g = godunov_gradient(merged_height(state.layers), scale, exit_slope)
    return torch.max(torch.sqrt(g[0] ** 2 + g[1] ** 2))


def summarize(state, scale):
    """One scalar dict per step: mass totals + max slope + extrema."""
    out = mass_totals(state, scale)
    out["max_slope"] = max_slope(state, scale)
    h = state.height
    out["height_min"] = torch.min(h)
    out["height_max"] = torch.max(h)
    return out


def throughput(cells: int, steps: int, seconds: float) -> float:
    """Grid-point-steps per second (the bench's headline unit)."""
    return cells * steps / seconds
