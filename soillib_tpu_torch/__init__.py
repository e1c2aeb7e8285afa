"""soillib_tpu_torch — the coupled erosion model and the DEM flow and
transport operations in PyTorch, with their kernels written by hand in
CUDA for the NVIDIA H100.

A port of `soillib_tpu` (the JAX/TPU package, which stays the reference)
that keeps its public names, its channel-first (C, W, H) model layouts,
its channel-last (W, H, C) ops-layer flow fields, its x-major flat index
and float32 throughout. It imports torch and numpy, never JAX and nothing
of `soillib_tpu`.

    import soillib_tpu_torch as soil
    state = soil.ErosionState.zeros((1024, 1024), height=h)  # on the card
    state = soil.erode(state, (0.1, 0.1, 4.0), soil.ErosionParams(), steps=8)

    filled = soil.fill_depressions(h)                        # on the card
    area = soil.accumulate(soil.steepest(filled, soil.d8), 1.0, soil.d8)

Entry points run on the card unless the caller passes `device="cpu"`
(the plain torch path, used by the tests); tensor inputs stay on their
device. The headline bench runs as `python -m soillib_tpu_torch.bench`;
the examples as `python -m soillib_tpu_torch.examples.<name>` (erosion,
multiscale, dem_process, dem_condition, dem_multiflow and the tiff_*
scripts), and the pod examples `erosion_pod` and `dem_mc_pod`. Sharded
execution over a mesh of ranks on `torch.distributed` is `parallel`.
"""

from soillib_tpu_torch.core.grid import (
    D4,
    D4_SHIFTS,
    D8,
    D8_SHIFTS,
    Shape,
    flatten,
    oob,
    unflatten,
)
from soillib_tpu_torch.core import metrics, morton
from soillib_tpu_torch.core.yieldgen import make_yield, prefetch, yield_t
from soillib_tpu_torch.core.timer import ms, ns, profile, s, timer, us
from soillib_tpu_torch.models.params import ErosionParams, param_t
from soillib_tpu_torch.models.erosion import (
    albedo_discharge,
    albedo_layer,
    albedo_stratum,
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
from soillib_tpu_torch.models.multiscale import (
    level_scale,
    resize_state,
    run_cascade,
)
from soillib_tpu_torch.ops.cohort import CohortClosure
from soillib_tpu_torch.ops.condition import condition, fill_depressions
from soillib_tpu_torch.ops.filter import gaussian_blur
from soillib_tpu_torch.ops.noise import noise, noise_t
from soillib_tpu_torch.ops.graph import (
    accumulate,
    accumulate_decay,
    direction,
    random_weighted,
    slope,
    steepest,
    upstream_distance,
    upstream_mask,
)
from soillib_tpu_torch.ops.resize import copy, resize
from soillib_tpu_torch.ops.stencil import gradient, laplacian, negslope, normal
from soillib_tpu_torch.ops.transport import solve_uniform
from soillib_tpu_torch.io.tiff import tiff
from soillib_tpu_torch.io.geotiff import geotiff, geotiff_meta
from soillib_tpu_torch.io.mesh import mesh
from soillib_tpu_torch import parallel, silt, util

# Reference-compatible edge-connectivity enumerators (graph.hpp:11-14).
d4 = D4
d8 = D8

__all__ = [
    "D4", "D8", "d4", "d8", "D4_SHIFTS", "D8_SHIFTS",
    "Shape", "flatten", "unflatten", "oob",
    "timer", "profile", "ns", "us", "ms", "s",
    "yield_t", "make_yield", "prefetch",
    "metrics", "morton", "silt",
    "gradient", "negslope", "laplacian", "normal",
    "gaussian_blur",
    "steepest", "direction", "random_weighted", "slope",
    "accumulate", "accumulate_decay", "upstream_mask", "upstream_distance",
    "noise", "noise_t",
    "condition", "fill_depressions",
    "resize", "copy",
    "solve_uniform",
    "ErosionParams", "param_t",
    "ErosionState", "ErosionSim", "erode", "make_erode_fn",
    "transport_fluvial", "transport_debris",
    "mass_transfer", "mass_creep", "layer_merge",
    "albedo_stratum", "albedo_layer", "albedo_discharge",
    "level_scale", "resize_state", "run_cascade",
    "CohortClosure",
    "tiff", "geotiff", "geotiff_meta", "mesh",
    "util",
    "parallel",
]
