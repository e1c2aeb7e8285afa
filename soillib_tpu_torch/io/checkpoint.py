"""The reference's de-facto checkpoint format (counterpart of
`zip_save` / `zip_load` in `soillib_tpu/io/checkpoint.py`): each field
written as a GeoTIFF, with its pixel scale, into a zip. The JAX package's
orbax step checkpoints are not ported.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from soillib_tpu_torch.io.geotiff import geotiff
from soillib_tpu_torch.io.tiff import _host


def zip_save(output: str, fields: dict, pscale=(1.0, 1.0, 1.0)):
    """Write each (name -> 2-D array or tensor) field as a float32 GeoTIFF
    into the zip `output`."""
    with zipfile.ZipFile(output, "w") as z:
        for name, field in fields.items():
            tmp = f"{output}.{name}.tmp.tiff"
            g = geotiff(_host(field).astype(np.float32))
            g.meta.scale = [float(pscale[0]), float(pscale[1]),
                            float(pscale[2])]
            g.write(tmp)
            z.write(tmp, arcname=f"{name}.tiff")
            os.remove(tmp)


def zip_load(path: str) -> dict:
    """Inverse of zip_save: name -> (numpy array, meta)."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            if not info.filename.endswith(".tiff"):
                continue
            tmp = f"{path}.{os.path.basename(info.filename)}.tmp"
            with open(tmp, "wb") as f:
                f.write(z.read(info.filename))
            g = geotiff(tmp)
            out[info.filename[: -len(".tiff")]] = (g.numpy(), g.meta)
            os.remove(tmp)
    return out
