"""Relief shading (diffuse hillshade) of DEMs (the counterpart of the JAX
package's examples/tiff_relief.py; reference: example/tiff_relief.py).

    python -m soillib_tpu_torch.examples.tiff_relief <file-or-dir>
        [--out DIR] [--device cuda|cpu]

The normals are computed on `--device`. Without --out each relief is
shown on screen; with --out DIR it is saved as a PNG there (both need
matplotlib); `--out ""` only computes and reports.
"""

from __future__ import annotations

import argparse
import os

import soillib_tpu_torch as soil


def main(argv=None) -> dict:
    """Run the example; returns {"reliefs": [(file, numpy relief), ...]}."""
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.tiff_relief")
    ap.add_argument("input")
    ap.add_argument("--out", default=None,
                    help="save PNGs here; \"\" skips the plots")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    reliefs = []
    for file, path in soil.util.iter_tiff(args.input):
        image = soil.geotiff(path)
        scale = image.meta.scale or (1.0, 1.0, 1.0)
        print(f"File: {file}", flush=True)
        h = image.tensor_on(args.device)
        reliefs.append((file, soil.util.relief_shade(
            h, soil.normal(h, scale))))
        if args.out == "":
            continue
        save = (os.path.join(args.out, file + ".relief.png") if args.out
                else None)
        if save:
            os.makedirs(args.out, exist_ok=True)
        soil.util.show_relief(h, scale, show=not save, save=save)
    return {"reliefs": reliefs}


if __name__ == "__main__":
    main()
