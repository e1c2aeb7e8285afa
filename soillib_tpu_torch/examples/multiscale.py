"""Multiscale erosion cascade on one card (the counterpart of the JAX
package's examples/erosion_tpu_multiscale.py, itself the reference's
example/erosion_gpu_multiscale.py): advance geological time on a coarse
grid, upsample every field, refine at finer levels, with the pixel scale
recomputed from the fixed 20 km world at each level (ksteps = [(128^2,
2048), (256^2, 4), (1000^2, 4)], :142-148). The final state is written as
GeoTIFFs in a zip (:166-170).

    python -m soillib_tpu_torch.examples.multiscale [--quick]
        [--levels RES:STEPS,...] [--out DIR] [--device cuda|cpu]

The parameters are the flagship example's (`examples.erosion.make_param`,
64 transport rounds); the terrain is the seed-3 FastNoiseLite field at
the first level's resolution. Each level prints its ms per step, timed
with `soil.timer`, which waits for the card. `--out ""` skips the zip.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import soillib_tpu_torch as soil
from soillib_tpu_torch.examples.erosion import make_param

DEFAULT_LEVELS = [((128, 128), 2048), ((256, 256), 4), ((1000, 1000), 4)]
QUICK_LEVELS = [((128, 128), 64), ((256, 256), 4), ((512, 512), 2)]
WORLD = (20.0, 20.0)   # [km]
ZSCALE = 4.0


def parse_levels(text):
    """"res:steps,res:steps,..." -> [((res, res), steps), ...]."""
    return [((int(r), int(r)), int(s))
            for r, s in (lv.split(":") for lv in text.split(","))]


def main(argv=None) -> dict:
    """Run the cascade; returns {"state": the final state, "levels": the
    levels run, "ms_per_step": each level's mean, "seconds": the
    cascade's total, "zip": the path of multiscale.zip, or None where
    `--out ""` skipped it}."""
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.multiscale")
    ap.add_argument("--quick", action="store_true",
                    help="small levels for a fast smoke run")
    ap.add_argument("--levels", default="",
                    help="cascade override as res:steps,res:steps,...")
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "erosion_multiscale_torch"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    if args.levels:
        levels = parse_levels(args.levels)
    elif args.quick:
        levels = QUICK_LEVELS
    else:
        levels = DEFAULT_LEVELS
    param = make_param()

    res0 = levels[0][0]
    height = soil.noise(res0, soil.noise_t(seed=3.0, ext=res0),
                        device=args.device)
    state = soil.ErosionState.zeros(res0, height=height, device=args.device)

    ms_per_step = []
    with soil.timer(soil.s) as total:
        for i, (res, steps) in enumerate(levels):
            with soil.timer(soil.ms) as t:
                state = soil.run_cascade(state, [(res, steps)], WORLD,
                                         ZSCALE, param)
                t.wait(state.layers)
            ms_per_step.append(t.elapsed * 1e3 / steps)
            print(f"level {i}: {res[0]}x{res[1]}, {steps} steps, "
                  f"{ms_per_step[-1]:.3f} ms/step, mean height "
                  f"{float(state.height.mean()):.4f}", flush=True)
        total.wait(state.layers)
    print(f"cascade total: {total.elapsed:.3f} s", flush=True)

    path = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "multiscale.zip")
        soil.util.zip_save(
            path,
            {"height": state.height, "sediment": state.sediment,
             "discharge": state.discharge},
            soil.level_scale(WORLD, ZSCALE, tuple(state.layers.shape[-2:])),
        )
        print(f"wrote {path}", flush=True)
    return {"state": state, "levels": levels, "ms_per_step": ms_per_step,
            "seconds": total.elapsed, "zip": path}


if __name__ == "__main__":
    main()
