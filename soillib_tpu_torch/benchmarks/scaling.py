"""Weak-scaling harness: the coupled erosion step, 1 rank -> N ranks
(counterpart of `benchmarks/scaling.py`).

Fixes the PER-RANK block size and grows the global grid with the mesh
(px * block x py * block, the most-square factorization), runs
`parallel.make_sharded_erode_fn` twice from the noise terrain and times
the second call on every rank (the slowest rank's time counts), and
prints one JSON line per mesh: cell-steps/s, per rank and the
efficiency against the first mesh (one rank unless `--procs` starts
elsewhere). One process runs each rank (`parallel.launch`); the JAX
harness's devices per process have no counterpart.

One card a rank:   python -m soillib_tpu_torch.benchmarks.scaling
                   [--block 1024] [--steps 4] [--iters 32]
                   (1, 2, 4, ... ranks over NCCL, up to the visible cards)
torchrun:          torchrun --nproc-per-node N -m
                   soillib_tpu_torch.benchmarks.scaling
                   (the world as one mesh over NCCL, and rank 0 alone)
CPU ranks:         --virtual N   (1, 2, 4, ... <= N gloo CPU ranks, one
                   thread each; validates the harness, the numbers are
                   not a device's)
Ranks on one card: --procs 1,2,4   (that many ranks sharing card 0 over
                   gloo, exchanges staged through host memory). CAVEAT:
                   one card running P programs is not scaling; each line
                   says so.
--out FILE writes the lines with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch import parallel as par
from soillib_tpu_torch.benchmarks.parity import device_line
from soillib_tpu_torch.convert import state_to_numpy
from soillib_tpu_torch.core.device import _device, seeded_generator
from soillib_tpu_torch.ops import cohort

CAVEAT = ("all ranks share one card; the numbers measure one card running "
          "several programs with host-staged exchanges, not hardware "
          "scaling")


def problem(W, H, iters, device):
    """The global initial state, scale and parameters of a W x H grid:
    the JAX harness's noise terrain (seed 3, ext = the grid), a 20 km
    world, default parameters at `iters` rounds."""
    scale = (20.0 / W, 20.0 / H, 4.0)
    param = soil.ErosionParams()
    param.transportIterations = iters
    height = soil.noise((W, H), soil.noise_t(seed=3.0, ext=(W, H)),
                        device=device)
    return soil.ErosionState.zeros((W, H), height=height,
                                   device=device), scale, param


def _sync(mesh):
    """Wait for this rank's device work, then for every rank."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    mesh.all_reduce(torch.zeros(1, device=mesh.device))


def rank_step(mesh, block, steps, iters, keep=False):
    """In each rank: `steps` sharded steps twice from the global problem
    of the mesh, the second call timed. Returns {"seconds", "launches"
    (the cohort kernel's launches in the timed call, by rule set),
    "state" (this rank's block of the result as numpy, with `keep`)}."""
    px, py = mesh.shape
    W, H = px * block, py * block
    state, scale, param = problem(W, H, iters, mesh.device)
    state = par.shard_state(state, mesh)
    step = par.make_sharded_erode_fn(mesh, scale, param, steps=steps)
    key = seeded_generator(mesh.device, 0)  # the field step draws nothing
    state = step(state, key)
    _sync(mesh)
    before = dict(cohort.cohort_round_launches)
    t0 = time.perf_counter()
    state = step(state, key)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dt = time.perf_counter() - t0
    launches = {k: n - before.get(k, 0)
                for k, n in cohort.cohort_round_launches.items()
                if n != before.get(k, 0)}
    _sync(mesh)
    return {"seconds": dt, "launches": launches,
            "state": state_to_numpy(state) if keep else None}


def global_state(results, mesh_shape):
    """The global state (numpy fields) from the ranks' `rank_step` blocks,
    rank r at mesh coordinate (r // py, r % py); a (..., 1, 1) constant
    field is every rank's whole field."""
    px, py = mesh_shape
    out = {}
    for name, first in results[0]["state"].items():
        if first.shape[-2:] == (1, 1):
            out[name] = first
            continue
        rows = [np.concatenate([results[cx * py + cy]["state"][name]
                                for cy in range(py)], axis=-1)
                for cx in range(px)]
        out[name] = np.concatenate(rows, axis=-2)
    return out


def measure(n, block, steps, iters, transport, devices, keep=False):
    """`rank_step` on n spawned ranks; returns (cell-steps/s at the
    slowest rank's time, the ranks' results)."""
    results = par.launch(rank_step, n, transport=transport, devices=devices,
                         args=(block, steps, iters, keep), timeout=1800)
    px, py = par.factor2(n)
    dt = max(r["seconds"] for r in results)
    return px * block * py * block * steps / dt, results


def line(n, rate, ref, caveat=None):
    """One JSON line of the JAX harness's keys; `ref` is (ranks, rate) of
    the first mesh, the efficiency's base."""
    eff = (rate / n) / (ref[1] / ref[0])
    out = {
        "devices": n,
        "cell_steps_per_s": round(rate, 1),
        "per_device": round(rate / n, 1),
        "weak_scaling_efficiency": round(eff, 4),
    }
    if caveat:
        out["caveat"] = caveat
    return out


def sweep(counts, block, steps, iters, transport, devices_of, caveat=None,
          log=print):
    """One `line` per rank count, each logged as it comes."""
    lines, ref = [], None
    for n in counts:
        rate, _ = measure(n, block, steps, iters, transport, devices_of(n))
        ref = ref or (n, rate)
        lines.append(line(n, rate, ref, caveat))
        log(json.dumps(lines[-1]))
    return lines


def _doubling(limit):
    n, out = 1, []
    while n <= limit:
        out.append(n)
        n *= 2
    return out


def run_torchrun(args, log=print):
    """Under torchrun: the world as one mesh over NCCL; the efficiency's
    base is rank 0 alone on a mesh of one rank without a group."""
    mesh = par.make_mesh(transport="nccl")
    cells = args.block ** 2 * args.steps
    base = None
    if mesh.size > 1 and mesh.rank == 0:
        single = par.Mesh((1, 1), 0, mesh.device, None)
        base = cells / rank_step(single, args.block, args.steps,
                                 args.iters)["seconds"]
    _sync(mesh)
    dt = torch.tensor([rank_step(mesh, args.block, args.steps,
                                 args.iters)["seconds"]],
                      dtype=torch.float64, device=mesh.device)
    torch.distributed.all_reduce(dt, op=torch.distributed.ReduceOp.MAX)
    torch.distributed.destroy_process_group()
    if mesh.rank != 0:
        return []
    rates = (([(1, base)] if base else [])
             + [(mesh.size, mesh.size * cells / float(dt))])
    lines = [line(n, rate, rates[0]) for n, rate in rates]
    for out in lines:
        log(json.dumps(out))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.benchmarks.scaling")
    ap.add_argument("--block", type=int, default=1024,
                    help="per-rank block edge")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--virtual", type=int, default=0,
                    help="1, 2, 4, ... <= N gloo CPU ranks")
    ap.add_argument("--procs", default="",
                    help="rank counts sharing card 0 over gloo, e.g. 1,2,4 "
                         "(see the module docstring's caveat)")
    ap.add_argument("--out", default="",
                    help="also write the lines, with the card's name and "
                         "power limit, to this JSON file")
    args = ap.parse_args(argv)

    if args.virtual:
        device = "cpu"
        lines = sweep(_doubling(args.virtual), args.block, args.steps,
                      args.iters, "gloo", lambda n: ["cpu"] * n)
    elif args.procs:
        device = _device("cuda")
        lines = sweep([int(n) for n in args.procs.split(",")], args.block,
                      args.steps, args.iters, "gloo",
                      lambda n: ["cuda:0"] * n, caveat=CAVEAT)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        lines = run_torchrun(args)
    else:
        device = _device("cuda")
        lines = sweep(_doubling(torch.cuda.device_count()), args.block,
                      args.steps, args.iters, "nccl",
                      lambda n: [f"cuda:{i}" for i in range(n)])
    if args.out and lines:
        with open(args.out, "w") as fh:
            json.dump({"device": device_line(device), "lines": lines}, fh,
                      indent=1)
    return lines


if __name__ == "__main__":
    main()
