"""Multiscale erosion cascade (counterpart of
`soillib_tpu/models/multiscale.py`; reference:
example/erosion_gpu_multiscale.py).

The reference advances geological time cheaply on a coarse grid, then
bilinearly upsamples every prognostic field and refines detail at finer
resolutions, recomputing the physical cell size from the fixed world
extent at each level (erosion_gpu_multiscale.py:102-148: ksteps =
[(128^2, 2048), (256^2, 4), (1000^2, 4)], pscale = wscale/res at
:107-109). Each level runs `erode` on the state's device: on the card its
cohort solves are launches of the cohort kernel at that level's size.
"""

from __future__ import annotations

import dataclasses

import torch

from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.models.simulation import (
    ErosionState,
    _particle_key,
    make_erode_fn,
)
from soillib_tpu_torch.ops.resize import resize


def resize_state(state: ErosionState, newres) -> ErosionState:
    """Bilinearly rescale every prognostic field to (newres[0], newres[1]).

    The reference's scaleup() resizes height, sediment, discharge,
    momentum, rainfall, uplift and the track fields one by one
    (erosion_gpu_multiscale.py:110-137); here every field of the state
    maps through `resize`, channel-first (C, W, H) fields per channel. A
    constant field ((1, 1) rainfall or uplift, (3, 1, 1) albedo) stays
    the same constant field: a bilinear sample of one value is that
    value."""
    nW, nH = int(newres[0]), int(newres[1])

    def field(a):
        if tuple(a.shape[-2:]) == (1, 1):
            return a
        if a.dim() == 2:
            return resize(a, (nW, nH))
        return torch.stack([resize(a[c], (nW, nH))
                            for c in range(a.shape[0])], dim=0)

    return state.replace(**{f.name: field(getattr(state, f.name))
                            for f in dataclasses.fields(state)})


def level_scale(world_extent, zscale, res):
    """Physical (sx, sy, sz) of a level: world extent / resolution
    (erosion_gpu_multiscale.py:107-109)."""
    return (
        float(world_extent[0]) / int(res[0]),
        float(world_extent[1]) / int(res[1]),
        float(zscale),
    )


def run_cascade(
    state: ErosionState,
    levels,
    world_extent,
    zscale,
    param: ErosionParams,
    key=None,
    mesh=None,
    on_level=None,
):
    """Run the multiscale cascade.

    Args:
      state: initial state at any resolution, on its device.
      levels: sequence of ((W, H), steps) per level, coarse to fine.
      world_extent: fixed world size (wx, wy) [km or m] shared by all levels.
      zscale: height dimensionalization (scale.z).
      param: erosion parameters (shared; the per-level pscale is what makes
        coarse levels advance more geological time per cell).
      key: a torch.Generator on the state's device or None (one seeded
        from 0 where the particle transports need it), passed on unchanged
        to every level's steps, which draw from it in turn (the JAX
        package splits its key once a level).
      mesh: optional `parallel.Mesh` (call in every rank of it, each with
        the whole state): each level runs block-decomposed
        (`parallel.make_sharded_erode_fn`) and its blocks are gathered
        back to every rank before the next level's resize; the result is
        the whole state on every rank.
      on_level: optional callback(level_index, resolution, state) after
        each level, for checkpointing/plotting.

    Returns the final state.
    """
    if mesh is not None:
        from soillib_tpu_torch import parallel as par

        if not isinstance(mesh, par.Mesh):
            raise TypeError(f"mesh must be a soillib_tpu_torch.parallel.Mesh, "
                            f"got {type(mesh).__name__}")
    key = _particle_key(key, state, param)
    for idx, (res, steps) in enumerate(levels):
        res = (int(res[0]), int(res[1]))
        # The resolution comes from the layers: rainfall and uplift may be
        # (1, 1) constant fields.
        if tuple(state.layers.shape[-2:]) != res:
            state = resize_state(state, res)
        scale = level_scale(world_extent, zscale, res)
        if mesh is not None:
            par.check_divisible(res, mesh)
            fn = par.make_sharded_erode_fn(mesh, scale, param,
                                           steps=int(steps))
            state = par.gather_state(fn(par.shard_state(state, mesh), key),
                                     mesh, everywhere=True)
        else:
            state = make_erode_fn(param, scale, steps=int(steps))(state, key)
        if on_level is not None:
            on_level(idx, res, state)
    return state
