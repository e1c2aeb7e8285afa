"""View TIFF/GeoTIFF DEMs (the counterpart of the JAX package's
examples/tiff_view.py; reference: example/tiff_view.py).

    python -m soillib_tpu_torch.examples.tiff_view <file-or-dir> [--out DIR]

Without --out each DEM is shown on screen; with --out DIR it is saved as
a PNG there (both need matplotlib); `--out ""` only loads and reports.
"""

from __future__ import annotations

import argparse
import os

import soillib_tpu_torch as soil


def main(argv=None) -> dict:
    """Run the example; returns {"images": [(file, numpy array), ...]}."""
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.tiff_view")
    ap.add_argument("input")
    ap.add_argument("--out", default=None,
                    help="save PNGs here; \"\" skips the plots")
    args = ap.parse_args(argv)

    images = []
    for file, path in soil.util.iter_tiff(args.input):
        data = soil.geotiff(path).numpy()
        print(f"File: {file}, {data.dtype}, {data.shape}", flush=True)
        images.append((file, data))
        if args.out == "":
            continue
        save = os.path.join(args.out, file + ".png") if args.out else None
        if save:
            os.makedirs(args.out, exist_ok=True)
        soil.util.show_height(data, show=not save, save=save)
    return {"images": images}


if __name__ == "__main__":
    main()
