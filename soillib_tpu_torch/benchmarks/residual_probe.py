"""Single-origin residual probe (counterpart of
`benchmarks/residual_probe.py`): is the closure residual cross-origin
pooling (colors can fix) or SELF-merging of one origin's flow (no birth
partition can)? Rainfall restricted to one 4x4 patch on the noise
terrain; field vs converged MC discharge.

    python -m soillib_tpu_torch.benchmarks.residual_probe [--size 48]
        [--seeds 24] [--cpu] [--out FILE]

Prints one JSON line with the JAX probe's keys (`--out` writes it too,
with the device it ran on).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch.benchmarks import parity
from soillib_tpu_torch.core.device import _device, seeded_generator

SCALE = (0.078, 0.078, 4.0)


def patch_rain(size, device):
    """Rainfall 1 on the 4x4 patch [10:14, 10:14], 0 elsewhere."""
    rain = torch.zeros((size, size), device=device)
    rain[10:14, 10:14] = 1.0
    return rain


def warm_state(size, device):
    """The noise terrain warmed 6 coupled steps with full rain (maxage 64,
    62 rounds, timeStep 500), so the terrain has structure."""
    terr = parity.make_terrains(size, ("noise",), device)["noise"]
    state = soil.ErosionState.zeros((size, size), height=terr, device=device)
    pw = soil.param_t()
    pw.maxage = 64
    pw.transportIterations = 62
    pw.timeStep = 500.0
    return soil.erode(state, SCALE, pw, steps=6)


def run(size=48, seeds=24, device="cuda"):
    """{field_vs_mc_corr, mc_floor_corr, field_total, mc_total}: the field
    discharge of the patch source against the mean of `seeds` MC
    estimates (seeds 0..seeds-1), and the two half-means' correlation."""
    dev = _device(device)
    st = warm_state(size, dev)
    rain = patch_rain(size, dev)
    p = soil.param_t()
    p.maxage = 128
    p.timeStep = 500.0
    p.nSamples = size * size * 64
    args = (st.layers, rain, st.discharge, st.mass, st.momentum,
            st.albedo_surface, SCALE, p)

    F = soil.transport_fluvial(*args)[0].cpu().numpy()
    Ms = torch.stack([
        soil.transport_fluvial(*args, method="particles",
                               key=seeded_generator(dev, s))[0]
        for s in range(seeds)]).cpu().numpy()
    M = np.mean(Ms, axis=0)
    M2 = np.mean(Ms[:seeds // 2], axis=0)
    M3 = np.mean(Ms[seeds // 2:], axis=0)

    def corr(a, b):
        return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])

    return {
        "field_vs_mc_corr": round(corr(F, M), 4),
        "mc_floor_corr": round(corr(M2, M3), 4),
        "field_total": float(F.sum()), "mc_total": float(M.sum()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.benchmarks.residual_probe")
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    out = run(args.size, args.seeds, device)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(out, device=parity.device_line(device)), fh,
                      indent=1)
    return out


if __name__ == "__main__":
    main()
