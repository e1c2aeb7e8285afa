"""soillib_tpu_torch — the coupled erosion model in PyTorch, with its
transport kernel written by hand in CUDA for the NVIDIA H100.

A port of `soillib_tpu` (the JAX/TPU package, which stays the reference)
that keeps its public names, its channel-first (C, W, H) layouts, its
x-major flat index and float32 throughout. It imports torch and numpy,
never JAX and nothing of `soillib_tpu`.

    import soillib_tpu_torch as soil
    state = soil.ErosionState.zeros((1024, 1024), height=h)  # on the card
    state = soil.erode(state, (0.1, 0.1, 4.0), soil.ErosionParams(), steps=8)

Entry points run on the card unless the caller passes `device="cpu"`
(the plain torch path, used by the tests).
"""

from soillib_tpu_torch.models.params import ErosionParams, param_t
from soillib_tpu_torch.models.erosion import (
    layer_merge,
    mass_creep,
    mass_transfer,
    transport_debris,
    transport_fluvial,
)
from soillib_tpu_torch.models.simulation import (
    ErosionSim,
    ErosionState,
    erode,
    make_erode_fn,
)
from soillib_tpu_torch.ops.cohort import CohortClosure

__all__ = [
    "ErosionParams", "param_t",
    "ErosionState", "ErosionSim", "erode", "make_erode_fn",
    "transport_fluvial", "transport_debris",
    "mass_transfer", "mass_creep", "layer_merge",
    "CohortClosure",
]
