"""Merge a directory of GeoTIFF tiles into one world-extent raster (the
counterpart of the JAX package's examples/tiff_merge.py; reference:
example/tiff_merge.py): compute the union world extent from every tile's
geo metadata, allocate the merged raster at a chosen pixel scale, blit
each tile in world space (`soil.copy`, tiff_merge.py:67) and save it with
merged metadata.

    python -m soillib_tpu_torch.examples.tiff_merge <dir> [--pscale 0.1]
        [--out merged.tiff] [--device cuda|cpu]

The blits run on `--device`. `--out ""` skips writing the raster.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch.core.device import _device


def main(argv=None) -> dict:
    """Run the example; returns {"merged": the (W, H) raster tensor,
    "scale": its pixel scale, "path": the file written or None}."""
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.tiff_merge")
    ap.add_argument("input")
    ap.add_argument("--pscale", type=float, default=0.1)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "merged.tiff"),
                    help="the merged GeoTIFF; \"\" skips writing it")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    # Pass 1: union world extent.
    wmin = np.array([np.inf, np.inf])
    wmax = np.array([-np.inf, -np.inf])
    wscale = None
    tiles = []
    for file, path in soil.util.iter_tiff(args.input):
        img = soil.geotiff(path)
        mmin, mmax = np.asarray(img.min), np.asarray(img.max)
        wmin = np.minimum(wmin, mmin)
        wmax = np.maximum(wmax, mmax)
        wscale = np.asarray(img.scale)
        tiles.append((file, path))
        print(f"tile {file}: extent {mmin} .. {mmax}", flush=True)
    if not tiles:
        raise SystemExit("no tiles found")

    shape = ((wmax - wmin) / wscale * args.pscale).astype(int)
    print(f"merged raster: {shape[0]}x{shape[1]} at pscale {args.pscale}",
          flush=True)
    merged = torch.full((int(shape[0]), int(shape[1])), float("nan"),
                        device=_device(args.device))

    # Pass 2: world-space blit of each tile.
    for file, path in tiles:
        img = soil.geotiff(path)
        merged = soil.copy(
            merged, img.tensor_on(merged.device),
            gmin=np.asarray(img.min), gmax=np.asarray(img.max),
            gscale=np.asarray(img.scale),
            wmin=wmin, wmax=wmax, wscale=wscale, pscale=args.pscale,
        )

    scale = [float(wscale[0] / args.pscale), float(wscale[1] / args.pscale),
             1.0]
    path = None
    if args.out:
        out = soil.geotiff(merged)
        out.meta.scale = scale
        out.write(args.out)
        path = args.out
        print(f"wrote {args.out}", flush=True)
    return {"merged": merged, "scale": scale, "path": path}


if __name__ == "__main__":
    main()
