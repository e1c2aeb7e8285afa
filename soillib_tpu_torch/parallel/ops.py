"""Sharded (block-decomposed) versions of the stencil and transport ops
(counterpart of `soillib_tpu/parallel/ops.py`).

Every function runs in each rank of a mesh on that rank's block and
returns that rank's block of the result. The stencil ops
(gradient/negslope/laplacian/normal/blur) pad the block with a `ShardHalo`
ring, apply the single-device op and crop: the ring holds either the
neighbours' data or the op's own boundary values, so the cropped result
equals the single-device op's block. steepest/direction/random_weighted
and solve_uniform take `halo=` in the single-device code and run it
there.

The JAX package runs its global-graph ops (`accumulate`,
`accumulate_decay`, `upstream_*`) as GSPMD-partitioned programs on sharded
arrays; torch has no such partitioner. Sharded inputs are accumulated by
`parallel.graph.accumulate` (block-local contraction and a global
boundary system).
"""

from __future__ import annotations

import math

import torch

from soillib_tpu_torch.core.device import as_field, seeded_generator
from soillib_tpu_torch.core.grid import D8
from soillib_tpu_torch.ops import filter as _filter
from soillib_tpu_torch.ops import graph as _graph
from soillib_tpu_torch.ops import stencil as _stencil
from soillib_tpu_torch.ops import transport as _transport
from soillib_tpu_torch.parallel.halo import ShardHalo

_KW = _filter._KWINDOW


def _padded(op, block, mesh, fill, radius, *args):
    """op(field, *args) on `block` padded by a `radius` ring of `fill`
    (constant or "edge"), cropped back. Valid for a local radius-`radius`
    stencil whose out-of-domain reads match `fill`."""
    halo = ShardHalo(mesh)
    x = as_field(block, mesh.device)
    return halo.crop(op(halo.pad(x, fill, radius), *args), radius)


def gradient(tensor, scale, mesh):
    """Sharded ops.stencil.gradient (NaN boundary, radius 1)."""
    return _padded(_stencil.gradient, tensor, mesh, math.nan, 1,
                   tuple(map(float, scale)))


def negslope(tensor, scale, mesh):
    return _padded(_stencil.negslope, tensor, mesh, math.nan, 1,
                   tuple(map(float, scale)))


def laplacian(tensor, scale, mesh):
    """Sharded ops.stencil.laplacian (clamp-to-edge boundary, radius 1)."""
    return _padded(_stencil.laplacian, tensor, mesh, "edge", 1,
                   tuple(map(float, scale)))


def normal(tensor, scale, mesh):
    return _padded(_stencil.normal, tensor, mesh, "edge", 1,
                   tuple(map(float, scale)))


def gaussian_blur(tensor, sigma, mesh):
    """Sharded separable blur: one radius-16 edge-fill exchange covers both
    passes (the +-16-tap window, filter.cu:34); blocks must be >= 16
    wide."""
    return _padded(_filter.gaussian_blur, tensor, mesh, "edge", _KW,
                   float(sigma))


def steepest(height, edge=D8, *, mesh):
    """Sharded steepest-descent receiver graph (global flat indices)."""
    return _graph.steepest(as_field(height, mesh.device), edge,
                           halo=ShardHalo(mesh))


def direction(height, edge=D8, *, mesh):
    return _graph.direction(as_field(height, mesh.device), edge,
                            halo=ShardHalo(mesh))


def random_weighted(height, edge=D8, seed=0, offset=0, T=1.0, *, mesh,
                    generator=None, u=None):
    """Sharded stochastic multiple-flow-direction graph. The per-cell
    uniforms are `u` (this rank's block) when given, else one global draw
    of the (W, H) grid from `generator` (or one seeded from (seed,
    offset)) on every rank, sliced to the block: the graph equals the
    single-device op's for the same draw."""
    h = as_field(height, mesh.device)
    if u is None:
        bw, bh = h.shape
        if generator is None:
            generator = seeded_generator(h.device, seed, offset)
        ug = torch.rand((bw * mesh.shape[0], bh * mesh.shape[1]),
                        generator=generator, device=generator.device,
                        dtype=h.dtype).to(h.device)
        cx, cy = mesh.coord
        u = ug[cx * bw:(cx + 1) * bw, cy * bh:(cy + 1) * bh]
    return _graph.random_weighted(h, edge, T=float(T), u=u,
                                  halo=ShardHalo(mesh))


def solve_uniform(flow, source, decay, scale=(1.0, 1.0), *, mesh,
                  iterations=None):
    """Sharded deterministic transport solve (ops.transport.solve_uniform,
    method='field'): one HALO_K-wide exchange of the payload before each
    HALO_K-round advance of the padded block (the sweep kernel on the
    card; `ShardHalo.run_transport`). `iterations` defaults to the global
    W + H."""
    flow = as_field(flow, mesh.device)
    W, H = flow.shape[0] * mesh.shape[0], flow.shape[1] * mesh.shape[1]
    iters = int(iterations) if iterations is not None else (W + H)
    return _transport.solve_uniform(
        flow, as_field(source, mesh.device), as_field(decay, mesh.device),
        tuple(map(float, scale)), method="field", iterations=iters,
        halo=ShardHalo(mesh))
