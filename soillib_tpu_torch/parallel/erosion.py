"""Block-decomposed coupled erosion (counterpart of
`soillib_tpu/parallel/erosion.py`).

`make_sharded_erode_fn` runs the single-device `erode_step` in every rank
of a mesh on that rank's block state, with a `ShardHalo` threading the
neighbour exchanges through each radius-1 stencil (the gradients, creep)
and through the transport and cohort solves (one HALO_K-wide exchange per
K-round pass). Each cell then computes what the single-device step
computes from the same inputs; the cohort deposits add round by round in
the single-device order.

Communication per step: 2 gradient exchanges, 1 creep exchange, and per
cohort solve one exchange of the aux fields plus one of the state every
K rounds (a K-wide ring of the (S, bw, bh) state): O(block edge) bytes
per pass against O(block area) work.
"""

from __future__ import annotations

from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.models.simulation import (
    ErosionState,
    _canonicalize,
    _particle_key,
    erode_step,
)
from soillib_tpu_torch.parallel.halo import ShardHalo
from soillib_tpu_torch.parallel.mesh import check_divisible, shard_state


def make_sharded_erode_fn(mesh, scale, param: ErosionParams, steps: int = 1,
                          state_template: ErosionState = None):
    """fn(state, key=None) -> state after `steps` coupled erosion steps,
    where `state` is this rank's block state (`parallel.shard_state` of
    the global state) and the result is its block of the result.

    The transport method must be "field" (the particle estimators shard
    through `parallel.particles`, not through the step). The parameters
    and scale are captured as they are now. `state_template`, a state
    with the global leaf shapes, is checked to split over the mesh. `key`
    is passed to every step as the single-device `erode` passes it (the
    field transports draw nothing), so a 1 x 1 mesh runs `erode`'s step."""
    if param.transportMethod != "field":
        raise ValueError(
            "sharded erosion requires param.transportMethod='field'")
    if state_template is not None:
        check_divisible(state_template.layers.shape[-2:], mesh)
    halo = ShardHalo(mesh)
    param = ErosionParams.from_frozen(param.freeze())
    scale = tuple(float(s) for s in scale)
    steps = int(steps)

    def fn(state, key=None):
        state = _canonicalize(state, param)
        key = _particle_key(key, state, param)
        for _ in range(steps):
            state = erode_step(state, scale, param, key, halo=halo)
        return state

    return fn


def sharded_erode(state: ErosionState, mesh, scale, param: ErosionParams,
                  steps: int = 1, key=None) -> ErosionState:
    """One-shot: this rank's block of the global `state` (which every rank
    holds) after `steps` sharded steps."""
    check_divisible(state.layers.shape[-2:], mesh)
    block = shard_state(state, mesh)
    return make_sharded_erode_fn(mesh, scale, param, steps)(block, key)
