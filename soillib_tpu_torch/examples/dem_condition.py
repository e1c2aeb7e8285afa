"""Hydrological DEM conditioning on one card (the counterpart of the JAX
package's examples/dem_condition.py; the reference's
example/dem_condition.py fills pits and resolves flats with pysheds,
dem_condition.py:32-49). Here the conditioning is the port's own
Planchon-Darboux fill (`soil.condition`); drainage is checked by counting
the interior cells without a receiver before and after.

    python -m soillib_tpu_torch.examples.dem_condition [dem.tiff]
        [--res 512] [--out FILE] [--device cuda|cpu]

On the card the accumulation runs the tile kernels. `--out ""` skips the
plot; any other --out needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch.examples.dem_process import load_or_synthesize


def main(argv=None) -> dict:
    """Run the example; returns "height", "filled", "flow", "area",
    "pits_before", "pits_after" and "ms" (the conditioning's)."""
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.dem_condition")
    ap.add_argument("dem", nargs="?", default=None)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "dem_condition.png"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    height, _ = load_or_synthesize(args.dem, args.res, 11.0, args.device)

    with soil.timer(soil.ms) as t:
        filled = t.wait(soil.condition(height, soil.d8))
    print(f"conditioned {tuple(height.shape)} in {t.elapsed * 1e3:.2f} ms",
          flush=True)

    flow = soil.steepest(filled, soil.d8)
    area = soil.accumulate(flow, torch.ones_like(filled), soil.d8)

    interior = torch.zeros(height.shape, dtype=torch.bool,
                           device=height.device)
    interior[1:-1, 1:-1] = True
    pits_before = int((soil.steepest(height, soil.d8) < 0)[interior].sum())
    pits_after = int((flow < 0)[interior].sum())
    print(f"interior pits: {pits_before} -> {pits_after}")
    print(f"fill volume: {float((filled - height).sum()):.1f}", flush=True)

    if args.out:
        soil.util.plot_area(area, show=False, save=args.out)
        print(f"wrote {args.out}", flush=True)
    return {"height": height, "filled": filled, "flow": flow, "area": area,
            "pits_before": pits_before, "pits_after": pits_after,
            "ms": t.elapsed * 1e3}


if __name__ == "__main__":
    main()
