"""Multiple-flow-direction contributing area by Gibbs ensemble on one card
(the counterpart of the JAX package's examples/dem_multiflow.py, itself
the reference's example/dem_multiflow.py: a 1024^2 DEM, K = 512
stochastic receiver graphs from `random_weighted` at temperature T, each
accumulated, averaged).

    python -m soillib_tpu_torch.examples.dem_multiflow [dem.tiff]
        [--K 512] [--T 10] [--batch 64] [--out FILE] [--device cuda|cpu]

Member m draws its uniforms from `random_weighted(seed=m)` (torch
numbers, not the JAX package's threefry keys). The members run in
batches as in the JAX example: the mean of each batch's areas, then
total += mean * k, so that with the same uniforms the sum runs in the JAX
example's order. On the card every member's accumulation runs the tile
kernels. `--out ""` skips the plot; any other --out needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch.examples.dem_process import load_or_synthesize


def multiflow(height, K, T, batch, u=None):
    """Mean contributing area of K members. `u`, when given, holds each
    member's (W, H) uniforms (u[m] for member m) in place of the draws."""
    rain = torch.ones_like(height)

    def member(m):
        draw = {"u": u[m]} if u is not None else {"seed": m}
        flow = soil.random_weighted(height, soil.d8, T=T, **draw)
        return soil.accumulate(flow, rain, soil.d8)

    total = torch.zeros_like(height)
    n = 0
    for b in range(0, K, batch):
        k = min(batch, K - b)
        mean = torch.stack([member(m) for m in range(b, b + k)]).mean(dim=0)
        total = total + mean * k
        n += k
    return total / n


def main(argv=None) -> dict:
    """Run the example; returns "height", "multiflow" and "ms_per_member"."""
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.dem_multiflow")
    ap.add_argument("dem", nargs="?", default=None)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--K", type=int, default=512)
    ap.add_argument("--T", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "dem_multiflow.png"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    height, _ = load_or_synthesize(args.dem, args.res, 7.0, args.device)
    with soil.timer(soil.s) as t:
        mf = t.wait(multiflow(height, args.K, args.T, args.batch))
    per = t.elapsed * 1e3 / args.K
    print(f"{args.K} ensemble members on {tuple(height.shape)} in "
          f"{t.elapsed:.2f}s ({per:.2f} ms/member)", flush=True)

    if args.out:
        soil.util.plot_area(mf, show=False, save=args.out)
        print(f"wrote {args.out}", flush=True)
    return {"height": height, "multiflow": mf, "ms_per_member": per}


if __name__ == "__main__":
    main()
