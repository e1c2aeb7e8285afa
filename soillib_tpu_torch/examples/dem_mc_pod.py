"""Distributional Monte-Carlo transport over a mesh of ranks
(counterpart of examples/dem_mc_pod.py).

No reference analog: the reference's MC solvers are single-GPU. This
example runs the particle estimators block-decomposed with particle
migration between ranks (soillib_tpu_torch.parallel.particles): a DEM's
steady-state water distribution estimated from millions of trajectories
whose particles hop between blocks as they cross seams, and the fluvial
MC transport sampled the same way.

One rank a card:  python -m soillib_tpu_torch.examples.dem_mc_pod
CPU ranks:        python -m soillib_tpu_torch.examples.dem_mc_pod
                  --virtual 4 --res 64
"""

import argparse
import time

import numpy as np
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch import parallel as par
from soillib_tpu_torch.core.device import seeded_generator
from soillib_tpu_torch.examples.erosion_pod import _sync, launch_ranks


def parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.dem_mc_pod")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--count", type=int, default=0,
                    help="particles (default 16x cells)")
    ap.add_argument("--virtual", type=int, default=0,
                    help="run N CPU ranks over gloo (no card needed)")
    ap.add_argument("--out", default="")
    return ap.parse_args(argv)


def problem(res, device):
    """The example's global inputs: terrain, its downslope flow field, unit
    source and 0.02 decay, and the fluvial state on 1 + 0.2 x terrain."""
    height = soil.noise(res, soil.noise_t(seed=3.0, ext=res), device=device)
    grad = soil.gradient(height, (0.5, 0.5))  # channel-LAST (W, H, 2)
    flow = -grad + 0.02
    source = torch.ones(res, dtype=torch.float32, device=device)
    decay = torch.full(res, 0.02, dtype=torch.float32, device=device)
    state = soil.ErosionState.zeros(res, height=1.0 + 0.2 * height,
                                    device=device)
    return flow, source, decay, state


def fluvial_params(N):
    p = soil.ErosionParams()
    p.maxage = 64
    p.nSamples = N
    return p


def run(mesh, args):
    """The example in one rank: returns (lines, {"uniform", "fluvial":
    gathered numpy fluxes, "dropped", "seconds"}) on rank 0, (None, None)
    elsewhere."""
    px, py = mesh.shape
    res = (args.res, args.res)
    par.check_divisible(res, mesh)
    N = args.count or 16 * res[0] * res[1]
    flow, source, decay, state = problem(res, mesh.device)
    def sh(a, spec=None):
        return par.shard_field(a, mesh, spec)

    lines = [f"mesh: {px}x{py} ({mesh.size} devices)"]
    out = {"dropped": {}, "seconds": {}}

    _sync(mesh)
    t0 = time.perf_counter()
    G, dropped = par.solve_particles_sharded(
        sh(flow, ("X", "Y", None)), sh(source), sh(decay), (0.5, 0.5), N,
        seeded_generator(mesh.device, 0), mesh)
    _sync(mesh)
    out["seconds"]["uniform"] = time.perf_counter() - t0
    out["dropped"]["uniform"] = dropped
    G = par.gather_field(G.contiguous(), mesh)
    if mesh.rank == 0:
        G = G.cpu().numpy()
        lines.append(f"uniform MC: {N} particles in "
                     f"{out['seconds']['uniform']:.1f}s, dropped {dropped}, "
                     f"mean flux {G.mean():.4f}")
        if not np.isfinite(G).all():
            raise AssertionError("uniform MC: non-finite flux")

    t0 = time.perf_counter()
    F, dropped = par.fluvial_particles_sharded(
        sh(state.layers), sh(state.rainfall), sh(state.discharge),
        sh(state.momentum), sh(state.albedo_surface), (0.5, 0.5, 2.0),
        fluvial_params(N), seeded_generator(mesh.device, 1), mesh)
    _sync(mesh)
    out["seconds"]["fluvial"] = time.perf_counter() - t0
    out["dropped"]["fluvial"] = dropped
    F = par.gather_field(F.contiguous(), mesh, spec=("X", "Y", None))
    if mesh.rank != 0:
        return None, None
    F = F.cpu().numpy()  # (W, H, 7) channel-last
    lines.append(f"fluvial MC: {out['seconds']['fluvial']:.1f}s, dropped "
                 f"{dropped}, water flux mean {F[..., 0].mean():.4f}")
    if not np.isfinite(F).all():
        raise AssertionError("fluvial MC: non-finite flux")
    out["uniform"], out["fluvial"] = G, F
    return lines, out


def main(argv=None):
    args = parse(argv)
    lines, out = launch_ranks(run, args)
    for line in lines or ():
        print(line)
    if args.out:
        np.savez(args.out, uniform=out["uniform"], fluvial=out["fluvial"])
        print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
