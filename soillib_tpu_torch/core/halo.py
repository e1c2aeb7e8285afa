"""Halo (ghost-cell) protocol — the seam between single-device and
block-decomposed execution (counterpart of `soillib_tpu/core/halo.py`).

Every radius-r stencil is written against this protocol:

    padded = halo.pad(field, fill)     # add an r-wide ring of neighbor data
    ...radius-r stencil arithmetic on `padded`...
    result = halo.crop(stencil_out)    # drop the ring

On a single device `NO_HALO` makes both calls the identity, so the ops run
as plain torch stencils whose internal `_shift` fills supply the boundary
conditions, and `run_transport` / `run_cohort` dispatch the solves by
device. The block-decomposed form is `parallel.halo.ShardHalo`: its ring
holds the neighbouring ranks' edge slabs (exchanged over
`torch.distributed`) or, at the domain edge, the op's own fill, and its
solves exchange a HALO_K-wide ring every HALO_K rounds.
"""

from __future__ import annotations


class NoHalo:
    """Single-device: identity pad/crop; the transport and cohort solves
    run on one device (the hand-written kernels for CUDA tensors, the
    plain torch rounds for CPU tensors)."""

    def pad(self, arr, fill, radius: int = 1):
        return arr

    def crop(self, arr, radius: int = 1):
        return arr

    def global_offsets(self, block_shape):
        """(x0, y0, W_global, H_global) of this block in the global grid."""
        return 0, 0, int(block_shape[0]), int(block_shape[1])

    def run_transport(self, E, att, vx, vy, iters: int):
        """`iters` rounds of the upwind transport fixed point
        G <- PUSH(att * (E + G)) with channel-first E, att (C, W, H) and
        (W, H) direction components (ops/sweep.py `run_transport`)."""
        from soillib_tpu_torch.ops import sweep

        return sweep.run_transport(E, att, vx, vy, iters)

    def run_cohort(self, st0, aux, rules, iters: int, Llen, closure=None,
                   tol: float = 0.0):
        """`iters` rounds of the age-structured cohort sweep -> (C, W, H)
        deposits (ops/cohort.py `run_cohort`). `tol` > 0 enables the
        convergence-adaptive depth exit."""
        from soillib_tpu_torch.ops import cohort

        return cohort.run_cohort(st0, aux, rules, iters, Llen, closure,
                                 tol=tol)


NO_HALO = NoHalo()
