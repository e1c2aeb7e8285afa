"""2-D domain decomposition over a mesh of ranks on `torch.distributed`
(counterpart of `soillib_tpu.parallel`).

Fields are block-decomposed over a px x py mesh, one process a block, all
running the same code. Radius-r stencils are fed by neighbour halo
exchanges, the transport and cohort solves exchange a HALO_K-wide ring
every HALO_K rounds, flow accumulation solves a global boundary system,
and the particle estimators migrate particles between blocks.

    from soillib_tpu_torch import parallel as par

    def rank(mesh, state):                  # runs in every rank
        block = par.shard_state(state, mesh)
        step = par.make_sharded_erode_fn(mesh, scale, param)
        return par.gather_state(step(block), mesh)

    out = par.launch(rank, 4, transport="gloo", devices=["cpu"] * 4,
                     args=(state,))[0]

Under torchrun, `par.make_mesh(transport="nccl")` joins the world (one
card a rank); several ranks that share one card use transport="gloo",
whose exchanges go through pinned host memory. `__all__` is the JAX
package's; the torch-only names (`Mesh`, `launch`, `gather_field`,
`gather_state`) are imported here too.
"""

from soillib_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    check_divisible,
    factor2,
    gather_field,
    gather_state,
    launch,
    leaf_spec,
    make_mesh,
    shard_field,
    shard_field_global,
    shard_state,
    shard_state_global,
    state_specs,
)
from soillib_tpu_torch.parallel.halo import ShardHalo, exchange_axis
from soillib_tpu_torch.parallel.erosion import (
    make_sharded_erode_fn,
    sharded_erode,
)
from soillib_tpu_torch.parallel.particles import (
    debris_particles_sharded,
    fluvial_particles_sharded,
    solve_particles_sharded,
)
from soillib_tpu_torch.parallel import graph, ops


def grid_spec(mesh=None) -> tuple:
    """How a (W, H) field splits: both dims, over ("X", "Y")."""
    return AXES


def grid_sharding(mesh=None) -> tuple:
    """The split of a (W, H) field (`grid_spec`); torch has no sharding
    object, a rank holds its block."""
    return grid_spec(mesh)


__all__ = [
    "AXES",
    "ShardHalo",
    "check_divisible",
    "exchange_axis",
    "factor2",
    "grid_sharding",
    "grid_spec",
    "make_mesh",
    "make_sharded_erode_fn",
    "graph",
    "ops",
    "debris_particles_sharded",
    "fluvial_particles_sharded",
    "shard_field",
    "shard_state",
    "sharded_erode",
    "solve_particles_sharded",
]
