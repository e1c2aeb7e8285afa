"""DEM processing on one card: flow direction, decayed accumulation and
the steady-state transport solve (the counterpart of the JAX package's
examples/dem_process.py, itself the reference's example/dem_process.py:
direction + accumulate_decay on a 1024^2 DEM and `solve_uniform`,
dem_process.py:72-90).

    python -m soillib_tpu_torch.examples.dem_process [dem.tiff]
        [--res 1024] [--particles] [--out FILE] [--device cuda|cpu]

fill_depressions -> steepest -> accumulate and accumulate_decay (decay
0.9999, a per-cell field) -> gradient -> solve_uniform along -grad h at
its default W+H rounds. On the card the accumulations run the tile
kernels and the solve the transport sweep kernel. As in the JAX example,
the flow pipeline (steepest and both accumulations) is warmed by one
untimed call and then timed; the sweep is warmed by a one-round solve on
the same shape (the first launch in a process builds the kernels); fill,
gradient and the solve are timed once.
`--particles` solves with the Monte-Carlo estimator instead
(`solve_uniform(method="particles", seed=0)`: W*H particles, W+H-1
rounds of plain torch, nothing to build or warm). `--out ""` skips the
plot; any other --out needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

import soillib_tpu_torch as soil


def load_or_synthesize(path, res, seed, device):
    """(height, scale): a GeoTIFF DEM, or FastNoiseLite noise x 400 at
    90 m cells."""
    if path:
        img = soil.geotiff(path)
        return img.tensor_on(device), (img.meta.scale or (1.0, 1.0, 1.0))
    h = soil.noise((res, res), soil.noise_t(seed=seed), device=device) * 400.0
    return h, (90.0, 90.0, 1.0)


def velocity_of(grad):
    """-grad h / max(|grad h|, 1e-6): the unit downhill direction."""
    return -grad / torch.clamp(
        torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-6)


def main(argv=None) -> dict:
    """Run the example; returns its fields ("height" filled, "flow",
    "area", "decayed", "gradient", "discharge") and "ms", each op's
    milliseconds."""
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.dem_process")
    ap.add_argument("dem", nargs="?", default=None)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--particles", action="store_true")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "dem_process.png"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    height, scale = load_or_synthesize(args.dem, args.res, 2.0, args.device)
    rain = torch.ones_like(height)
    decay = torch.full_like(height, 0.9999)
    evap = torch.full_like(height, 0.001)
    method = "particles" if args.particles else "field"

    ms, f = {}, {}

    def op(name, fn):
        with soil.timer(soil.ms) as t:
            out = t.wait(fn())
        ms[name] = t.elapsed * 1e3
        return out

    def solve(velocity, iterations=None):
        return soil.solve_uniform(velocity, rain, evap, scale[:2],
                                  method=method, seed=0,
                                  iterations=iterations)

    f["height"] = op("fill_depressions",
                     lambda: soil.fill_depressions(height))
    # One untimed pass of the flow pipeline builds the tile kernels.
    flow = soil.steepest(f["height"], soil.d8)
    soil.accumulate(flow, rain, soil.d8)
    soil.accumulate_decay(flow, rain, decay, soil.d8)
    f["flow"] = op("steepest", lambda: soil.steepest(f["height"], soil.d8))
    f["area"] = op("accumulate",
                   lambda: soil.accumulate(f["flow"], rain, soil.d8))
    f["decayed"] = op("accumulate_decay", lambda: soil.accumulate_decay(
        f["flow"], rain, decay, soil.d8))
    f["gradient"] = op("gradient",
                       lambda: soil.gradient(f["height"], scale[:2]))
    velocity = velocity_of(f["gradient"])
    if method == "field":
        solve(velocity, iterations=1)  # builds the sweep kernel
    f["discharge"] = op("solve_uniform", lambda: solve(velocity))
    print(f"ops on {tuple(height.shape)} [ms]: "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()), flush=True)

    if args.out:
        soil.util.plot_images([torch.log1p(f["area"]),
                               torch.log1p(f["discharge"])],
                              show=False, save=args.out)
        print(f"wrote {args.out}", flush=True)
    return {**f, "ms": ms}


if __name__ == "__main__":
    main()
