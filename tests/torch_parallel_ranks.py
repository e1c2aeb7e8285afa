"""The ranks' side of the port's sharded-execution tests.

`run_cases` runs in every rank of a mesh made by
`soillib_tpu_torch.parallel.launch`: one launch per test module feeds it
all the module's cases, (name, inputs) pairs of numpy arrays made from a
seed in the test process, and rank 0 returns {name: results}, the
sharded results gathered to whole fields. The single-device references
that must agree bitwise are computed on rank 0 too, with the same thread
count as the sharded ops. Imports torch, numpy and soillib_tpu_torch
only (the ranks never import JAX).
"""

from __future__ import annotations

import os

import numpy as np
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch import parallel as par
from soillib_tpu_torch.convert import (
    params_from_frozen,
    state_from_numpy,
    state_to_numpy,
)
from soillib_tpu_torch.core.device import seeded_generator
from soillib_tpu_torch.models import erosion as ero
from soillib_tpu_torch.ops import transport
from soillib_tpu_torch.ops.stencil import _shift
from soillib_tpu_torch.parallel import halo as H
from soillib_tpu_torch.testing import injected_births

CL = ("X", "Y", None)  # a channel-last field's split


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gather(mesh, block, spec=None):
    out = par.gather_field(block.contiguous(), mesh, spec=spec)
    return None if out is None else out.cpu().numpy()


def case_halo(mesh, x):
    halo = par.ShardHalo(mesh)
    b = par.shard_field(x, mesh)
    out = {"crop": _gather(mesh, halo.crop(halo.pad(b, 0.0)))}
    for dx, dy in [(-1, 0), (1, 0), (0, -1), (0, 1), (1, 1), (-1, 1)]:
        s = halo.crop(_shift(halo.pad(b, float("nan")), dx, dy, float("nan")))
        out[f"shift{dx},{dy}"] = _gather(mesh, s)
    return out


def case_stencils(mesh, h, h2, scale2, scale3, sigma):
    b = par.shard_field(h, mesh)
    out = {
        "gradient": _gather(mesh, par.ops.gradient(b, scale2, mesh), CL),
        "negslope": _gather(mesh, par.ops.negslope(b, scale2, mesh), CL),
        "laplacian": _gather(mesh, par.ops.laplacian(b, scale2, mesh)),
        "normal": _gather(mesh, par.ops.normal(b, scale3, mesh), CL),
        "blur": _gather(mesh, par.ops.gaussian_blur(
            par.shard_field(h2, mesh), sigma, mesh)),
    }
    return out


def case_graphs(mesh, h, u, seed, offset, T):
    b = par.shard_field(h, mesh)
    return {
        "steepest8": _gather(mesh, par.ops.steepest(b, soil.d8, mesh=mesh)),
        "steepest4": _gather(mesh, par.ops.steepest(b, soil.d4, mesh=mesh)),
        "direction8": _gather(mesh, par.ops.direction(b, soil.d8,
                                                      mesh=mesh)),
        "rw_injected": _gather(mesh, par.ops.random_weighted(
            b, soil.d8, T=T, mesh=mesh, u=par.shard_field(u, mesh))),
        "rw_drawn": _gather(mesh, par.ops.random_weighted(
            b, soil.d8, seed=seed, offset=offset, T=T, mesh=mesh)),
    }


def case_solve(mesh, flow, source, decay, scale, iterations):
    got = par.ops.solve_uniform(
        par.shard_field(flow, mesh, CL), par.shard_field(source, mesh),
        par.shard_field(decay, mesh), scale, mesh=mesh,
        iterations=iterations)
    out = {"got": _gather(mesh, got)}
    if mesh.rank == 0:
        out["single"] = soil.solve_uniform(
            _t(flow), _t(source), _t(decay), scale, method="field",
            iterations=iterations).numpy()
    return out


def case_ledger(mesh, C, W, Hh, K):
    b = torch.zeros((C, W // mesh.shape[0], Hh // mesh.shape[1]))
    with H.halo_ledger(timed=True) as entries:
        par.ShardHalo(mesh).pad_cf(b, 0.0, K)
        return {"entries": list(entries)}


def _erode_case(mesh, fields, frozen, scale, steps, overlap=False):
    state = state_from_numpy(fields, mesh.device)
    param = params_from_frozen(frozen)
    if overlap:
        os.environ["SOIL_HALO_OVERLAP"] = "1"
    try:
        got = par.sharded_erode(state, mesh, scale, param, steps=steps)
    finally:
        os.environ.pop("SOIL_HALO_OVERLAP", None)
    g = par.gather_state(got, mesh)
    return None if g is None else state_to_numpy(g)


def case_erode(mesh, fields, frozen, scale, steps, single=True,
               overlap=False):
    """The sharded step(s) of the global state `fields` on the mesh's
    device, gathered, and rank 0's single-device steps there."""
    out = {"got": _erode_case(mesh, fields, frozen, scale, steps),
           "transport": mesh.transport_name}
    if overlap:
        out["overlap"] = _erode_case(mesh, fields, frozen, scale, steps,
                                     overlap=True)
    if single and mesh.rank == 0:
        out["single"] = state_to_numpy(soil.erode(
            state_from_numpy(fields, mesh.device), scale,
            params_from_frozen(frozen), steps=steps))
    return out


def case_cascade(mesh, fields, levels, world, zscale, frozen):
    got = soil.run_cascade(state_from_numpy(fields, "cpu"), levels, world,
                           zscale, params_from_frozen(frozen), mesh=mesh)
    return {"got": state_to_numpy(got)}


def case_accumulate(mesh, flows, rain, decay):
    out = {}
    for edge, flow in flows.items():
        g = par.shard_field(flow, mesh)
        r = par.shard_field(rain, mesh)
        out[f"plain{edge}"] = _gather(mesh, par.graph.accumulate(
            g, r, edge, mesh=mesh))
        out[f"decay{edge}"] = _gather(mesh, par.graph.accumulate(
            g, r, edge, mesh=mesh, decay=par.shard_field(decay, mesh)))
        out[f"scalar{edge}"] = _gather(mesh, par.graph.accumulate(
            g, 1.0, edge, mesh=mesh, decay=0.9))
    return out


def case_accumulate_pipeline(mesh, h):
    """Sharded steepest into the distributed accumulate, as a pod DEM
    workflow runs them."""
    b = par.shard_field(h, mesh)
    flow = par.ops.steepest(b, soil.d8, mesh=mesh)
    return {"flow": _gather(mesh, flow),
            "area": _gather(mesh, par.graph.accumulate(
                flow, 1.0, soil.d8, mesh=mesh))}


def case_particles(mesh, flow, source, decay, scale, count, draws, slack):
    with injected_births(draws):
        G, dropped = par.solve_particles_sharded(
            par.shard_field(flow, mesh, CL), par.shard_field(source, mesh),
            par.shard_field(decay, mesh), scale, count,
            seeded_generator("cpu"), mesh, slack=slack)
    return {"got": _gather(mesh, G), "dropped": dropped}


def _erosion_fields(fields, mesh, names):
    return [par.shard_field(fields[k], mesh) for k in names]


def case_fluvial(mesh, fields, frozen, scale, draws):
    p = params_from_frozen(frozen)
    args = _erosion_fields(fields, mesh, ("layers", "rainfall", "discharge",
                                          "momentum", "albedo_surface"))
    with injected_births(draws):
        F, dropped = par.fluvial_particles_sharded(
            *args, scale, p, seeded_generator("cpu"), mesh, slack=2.0)
    return {"got": _gather(mesh, F, CL), "dropped": dropped}


def case_debris(mesh, fields, frozen, scale, draws):
    p = params_from_frozen(frozen)
    args = _erosion_fields(fields, mesh, ("layers", "mass", "momentum",
                                          "albedo_surface"))
    with injected_births(draws):
        F, dropped = par.debris_particles_sharded(
            *args, scale, p, seeded_generator("cpu"), mesh, slack=2.0)
    return {"got": _gather(mesh, F, CL), "dropped": dropped}


def run_cases(mesh, cases):
    """Every (name, function name, inputs) case in turn, in every rank;
    rank 0's {name: results}."""
    out = {}
    for name, fn, kw in cases:
        with torch.no_grad():
            out[name] = globals()[f"case_{fn}"](mesh, **kw)
    return out if mesh.rank == 0 else None


def single_fluvial(fields, frozen, scale, draws):
    """The port's single-device fluvial estimator with injected births,
    channel-last (W, H, 7) as the sharded estimators return it."""
    st = state_from_numpy(fields, "cpu")
    with injected_births(draws):
        F = ero._fluvial_particles(
            st.layers, st.rainfall, st.discharge, st.momentum,
            st.albedo_surface, scale, params_from_frozen(frozen),
            seeded_generator("cpu"))
    return F.T.reshape(*st.discharge.shape, 7).numpy()


def single_debris(fields, frozen, scale, draws):
    st = state_from_numpy(fields, "cpu")
    with injected_births(draws):
        F = ero._debris_particles(
            st.layers, st.mass, st.momentum, st.albedo_surface, scale,
            params_from_frozen(frozen), seeded_generator("cpu"))
    return F.T.reshape(*st.mass.shape, 6).numpy()


def single_particles(flow, source, decay, scale, count, draws):
    with injected_births(draws):
        return transport._solve_particles(
            _t(flow), _t(source), _t(decay), scale, count,
            seeded_generator("cpu"), maxstep=flow.shape[0] + flow.shape[1]
        ).numpy()
