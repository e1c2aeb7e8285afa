"""Pod-scale erosion: 2-D block decomposition over a mesh of ranks
(counterpart of examples/erosion_pod.py).

No reference analog: the reference is single-GPU. Every field is
block-decomposed over an ("X", "Y") mesh of ranks; the radius-1 stencils
and the transport and cohort solves exchange halos between neighbouring
ranks (soillib_tpu_torch.parallel).

One rank a card:  python -m soillib_tpu_torch.examples.erosion_pod
                  (spans the visible cards, transport nccl)
torchrun:         torchrun --nproc-per-node N -m
                  soillib_tpu_torch.examples.erosion_pod
CPU ranks:        python -m soillib_tpu_torch.examples.erosion_pod
                  --virtual 4 --res 64 --steps 2   (N ranks over gloo)
Several ranks on one card: call `run` through `parallel.launch(...,
transport="gloo", devices=["cuda"] * N)` (host-staged exchanges).
"""

import argparse
import os
import time

import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch import parallel as par
from soillib_tpu_torch.examples.erosion import make_param


def parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.erosion_pod")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--virtual", type=int, default=0,
                    help="run N CPU ranks over gloo (no card needed)")
    return ap.parse_args(argv)


def _sync(mesh):
    """Wait for this rank's device work, then for every rank."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    mesh.all_reduce(torch.zeros(1, device=mesh.device))


def run(mesh, args):
    """The example in one rank: returns (lines to print, ms a step) on
    rank 0, (None, None) elsewhere."""
    px, py = mesh.shape
    res = (args.res, args.res)
    par.check_divisible(res, mesh)
    wscale = (20.0, 20.0, 4.0)
    pscale = (wscale[0] / res[0], wscale[1] / res[1], wscale[2])

    param = make_param()
    param.transportIterations = 32
    height = soil.noise(res, soil.noise_t(seed=3.0, ext=res),
                        device=mesh.device)
    state = par.shard_state(
        soil.ErosionState.zeros(res, height=height, device=mesh.device),
        mesh)

    step = par.make_sharded_erode_fn(mesh, pscale, param, steps=args.steps)
    state = step(state)                 # warm-up: the kernels' first calls
    _sync(mesh)
    t0 = time.perf_counter()
    state = step(state)
    _sync(mesh)
    dt = time.perf_counter() - t0

    bad = mesh.all_reduce(
        (~torch.isfinite(state.layers)).sum().reshape(1).float())
    if float(bad[0]) != 0.0:
        raise AssertionError(f"{int(bad[0])} non-finite layer values")
    if mesh.rank != 0:
        return None, None
    cells = res[0] * res[1]
    return [
        f"mesh: {px}x{py} ({mesh.size} devices, {mesh.size} processes)",
        f"{args.steps} steps at {res[0]}x{res[1]}: "
        f"{dt / args.steps * 1e3:.2f} ms/step, "
        f"{cells * args.steps / dt / 1e6:.1f} M cell-steps/s "
        f"across {mesh.size} devices",
    ], dt / args.steps * 1e3


def launch_ranks(fn, args):
    """fn(mesh, args) in every rank: N CPU ranks over gloo (--virtual N),
    this process's rank of a torchrun world (nccl), or one rank a visible
    card (nccl). Returns rank 0's result."""
    if args.virtual:
        return par.launch(fn, args.virtual, transport="gloo",
                          devices=["cpu"] * args.virtual, args=(args,))[0]
    if "RANK" in os.environ:
        return fn(par.make_mesh(transport="nccl"), args)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass --virtual N "
                           "to run N CPU ranks")
    return par.launch(fn, n, transport="nccl", args=(args,))[0]


def main(argv=None):
    args = parse(argv)
    lines, ms = launch_ranks(run, args)
    for line in lines or ():
        print(line)
    return ms


if __name__ == "__main__":
    main()
