"""Terrain triangulation -> PLY export (the counterpart of the JAX
package's examples/tiff_mesh.py; reference: example/tiff_mesh.py).

    python -m soillib_tpu_torch.examples.tiff_mesh <file-or-dir> [out.ply]

The triangulation runs in numpy on the host, as in the JAX package; the
binary PLY is the same bytes. It draws no plot.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import soillib_tpu_torch as soil


def main(argv=None) -> dict:
    """Run the example; returns {"mesh": the last file's mesh, "path":
    the PLY written}."""
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.examples.tiff_mesh")
    ap.add_argument("input")
    ap.add_argument("output", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "out.ply"))
    args = ap.parse_args(argv)

    m = None
    for file, path in soil.util.iter_tiff(args.input):
        image = soil.geotiff(path)
        scale = image.meta.scale or (1.0, 1.0, 1.0)
        print(f"File: {file}", flush=True)
        m = soil.mesh(image.numpy(), [scale[0], scale[1], 1.0])
        m.center()
        m.write_binary(args.output)
        print(f"wrote {args.output}: {len(m.vertices)} vertices, "
              f"{len(m.faces)} faces", flush=True)
    return {"mesh": m, "path": args.output}


if __name__ == "__main__":
    main()
