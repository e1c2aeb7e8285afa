"""Grid index-space conventions (counterpart of `soillib_tpu/core/grid.py`).

Fields are (W, H) tensors with axis 0 = x and the x-major flat index
flat = x * H + y, so `t.reshape(-1)[x * H + y] == t[x, y]`.

Neighbor stencils mirror graph.hpp:21-46: D4 = 4 cardinal shifts, D8 adds
the 4 diagonals *after* the cardinals. The slot order matters: the slot
graphs, the tiled accumulation kernels and accumulate_decay's compacted-
slot decay^1.414 quirk (graph.cu:401-413) all index these tables.
"""

from __future__ import annotations

import numpy as np

# Edge-connectivity enumerators (graph.hpp:11-14).
D4 = 0
D8 = 1

# Neighbor shift tables, (K, 2) int32, order matches graph.hpp:21-46.
D4_SHIFTS = np.array(
    [[-1, 0], [0, -1], [0, 1], [1, 0]], dtype=np.int32
)
D8_SHIFTS = np.array(
    [[-1, 0], [0, -1], [0, 1], [1, 0], [-1, -1], [-1, 1], [1, -1], [1, 1]],
    dtype=np.int32,
)


def shifts_for(edge: int) -> np.ndarray:
    """Shift table for an edge enumerator (D4 or D8)."""
    if edge == D4:
        return D4_SHIFTS
    if edge == D8:
        return D8_SHIFTS
    raise ValueError(f"invalid edge enumerator: {edge!r}")


def shift_lengths(edge: int) -> np.ndarray:
    """Euclidean length of each neighbor shift, (K,) float32."""
    sh = shifts_for(edge).astype(np.float32)
    return np.sqrt((sh ** 2).sum(axis=-1))


def check_channel_last(name: str, arr, channels=(2,)):
    """Validate that `arr` is a channel-LAST (W, H, C) field.

    The ops layer (gradient / solve_uniform flow fields) is channel-last,
    while the model state is channel-FIRST (C, W, H). A mis-laid-out array
    silently reads garbage W/H, so every channel-last entry point
    validates here and names the expected layout."""
    shape = tuple(arr.shape)
    if len(shape) != 3 or shape[-1] not in tuple(channels):
        want = "|".join(str(c) for c in channels)
        raise ValueError(
            f"{name} must be channel-LAST (W, H, {want}); got shape {shape}. "
            f"Note: soil.gradient already returns (W, H, 2) — do not moveaxis "
            f"it. Models/parallel state is channel-FIRST (C, W, H); ops-layer "
            f"flow/gradient fields are channel-LAST."
        )


def check_channel_first(name: str, arr, channels):
    """Validate that `arr` is a channel-FIRST (C, W, H) field (the model
    state convention; see check_channel_last)."""
    shape = tuple(arr.shape)
    if len(shape) != 3 or shape[0] not in tuple(channels):
        want = "|".join(str(c) for c in channels)
        raise ValueError(
            f"{name} must be channel-FIRST ({want}, W, H); got shape {shape}. "
            f"Models/parallel state is channel-FIRST; only ops-layer "
            f"flow/gradient fields are channel-LAST (W, H, C)."
        )
