"""Coupled hydraulic + debris-flow erosion on one card: the flagship
workload (the counterpart of the JAX package's examples/erosion_tpu.py,
itself the reference's example/erosion_gpu.py: a 256^2 grid, a 20 km
world, 512 coupled steps, timed per step).

    python -m soillib_tpu_torch.examples.erosion [--res 256] [--steps 512]
        [--report 32] [--out DIR] [--quality] [--faithful]
        [--device cuda|cpu]

The parameters mirror the reference script's (`make_param`); the terrain
is the seed-3 FastNoiseLite field. Each report prints the mean ms per
step of its block of steps, timed with `soil.timer`, which waits for the
card. The final height, sediment and discharge go into `erosion.zip` in
--out (GeoTIFFs with the pixel scale, readable with `soil.util.zip_load`).
The JAX example also saves two PNG plots; this one does not, because they
need matplotlib, which the port does not depend on.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import soillib_tpu_torch as soil


def make_param() -> soil.ErosionParams:
    p = soil.param_t()
    p.timeStep = 1000.0
    p.samples = 8192
    p.maxage = 256
    p.lrate = 1.0
    p.gravity = 9.81
    p.uplift = 0.01
    p.rainfall = 1.0
    p.evapRate = 0.0005
    p.viscosity = 0.000001          # legacy alias -> viscosityWater
    p.bedShear = 12.5
    p.suspensionRate = 0.0008
    p.depositionRate = 0.00001
    p.fluvialExponent = 0.01
    p.exitSlope = 0.025
    p.critSlope = 0.57
    p.debrisCreepRate = 0.0025
    p.debrisSuspensionRate = 0.00025
    p.debrisDepositionRate = 0.0001
    p.debrisYieldStress = 2e6
    p.debrisDensity = 2500.0
    p.debrisViscosity = 0.004
    p.debrisBedShear = 60 / 2500.0
    p.transportIterations = 64      # deterministic field-solve rounds
    return p


def main(argv=None) -> dict:
    """Run the example; returns {"sim": the simulation after the last
    step, "zip": the path of erosion.zip, "ms_per_step": the mean of each
    report's block}."""
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.erosion")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--report", type=int, default=32)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "erosion_torch"))
    ap.add_argument("--quality", action="store_true",
                    help="mixture quality mode: CohortClosure(nodes=4, "
                         "colors=8) on the fluvial solve; debris keeps "
                         "the default closure (ErosionParams."
                         "closureDebris)")
    ap.add_argument("--faithful", action="store_true",
                    help="reference-faithful transport depth: maxage-2 "
                         "rounds as the bound with the adaptive exit "
                         "(transportTol=1e-6)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    res = (args.res, args.res)
    wscale = (20.0, 20.0, 4.0)                      # world scale [km]
    pscale = (wscale[0] / res[0], wscale[1] / res[1], wscale[2])

    height = soil.noise(res, soil.noise_t(seed=3.0, ext=(res[0], res[1])),
                        device=args.device)
    state = soil.ErosionState.zeros(res, height=height, device=args.device)
    param = make_param()
    if args.quality:
        param.closure = soil.CohortClosure(nodes=4, colors=8)
    if args.faithful:
        param.transportIterations = 0   # -> maxage-2 rounds (the bound)
        param.transportTol = 1e-6       # adaptive exit pays only live rounds

    sim = soil.ErosionSim(res, pscale, param, state=state)
    done = 0
    ms_per_step = []
    while done < args.steps:
        n = min(args.report, args.steps - done)
        with soil.timer(soil.ms) as t:
            sim.step(n)
            t.wait(sim.state.layers)
        done += n
        ms_per_step.append(t.count / n)
        print(f"steps {done:4d}/{args.steps}: {t.count / n:.2f} ms/step",
              flush=True)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "erosion.zip")
    soil.util.zip_save(
        path,
        {
            "height": sim.state.height,
            "sediment": sim.state.sediment,
            "discharge": sim.state.discharge,
        },
        pscale,
    )
    print(f"wrote {path}", flush=True)
    return {"sim": sim, "zip": path, "ms_per_step": ms_per_step}


if __name__ == "__main__":
    main()
