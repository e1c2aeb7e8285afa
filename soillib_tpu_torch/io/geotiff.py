"""`geotiff` — GeoTIFF / GDAL extension of `tiff` (a copy of
`soillib_tpu/io/geotiff.py`; files written by either package are the same
bytes).

Reproduces the reference's geotiff surface (io/geotiff.hpp:64-127, binding
io.cpp:39-100): the 9 custom GDAL/GeoTIFF tags (GeoPixelScale, GeoTiePoints,
Intergraph/GeoTransMatrix, GeoKeyDirectory, GeoDouble/AsciiParams,
GDAL_METADATA, GDAL_NODATA), a read/write `meta` struct, nodata <-> NaN
conversion, and world-space min/max/map projection helpers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from soillib_tpu_torch.io import tiffcore
from soillib_tpu_torch.io.tiff import tiff

# GeoTIFF / GDAL tag ids (io/geotiff.hpp:12-20)
TAG_GEOPIXELSCALE = 33550
TAG_INTERGRAPH_MATRIX = 33920
TAG_GEOTIEPOINTS = 33922
TAG_GEOTRANSMATRIX = 34264
TAG_GEOKEYDIRECTORY = 34735
TAG_GEODOUBLEPARAMS = 34736
TAG_GEOASCIIPARAMS = 34737
TAG_GDAL_METADATA = 42112
TAG_GDAL_NODATA = 42113


@dataclasses.dataclass
class geotiff_meta:
    """GeoTIFF metadata (io/geotiff.hpp:87-105)."""

    filename: str = ""
    width: int = 0
    height: int = 0
    bits: int = 32
    gdal_nodata: str = ""
    gdal_metadata: str = ""
    geoasciiparams: str = ""
    scale: list = dataclasses.field(default_factory=lambda: [1.0, 1.0, 1.0])
    coords: list = dataclasses.field(default_factory=lambda: [0.0] * 6)
    params: list = dataclasses.field(default_factory=list)
    keydir: list = dataclasses.field(default_factory=list)
    # Matrix georeferencing (present INSTEAD of the tie-point/scale pair
    # in some products): the 4x4 GeoTransMatrix (tag 34264, 16 doubles)
    # and the legacy Intergraph matrix (tag 33920). Loaded and re-emitted
    # verbatim so matrix-only GeoTIFFs keep their projection through a
    # read -> write cycle (io/geotiff.hpp:12-50, write-back :194-241).
    matrix: list = dataclasses.field(default_factory=list)
    intergraph: list = dataclasses.field(default_factory=list)

    # legacy binding alias (io.cpp:87)
    @property
    def gdal_ascii(self):
        return self.geoasciiparams

    @gdal_ascii.setter
    def gdal_ascii(self, v):
        self.geoasciiparams = v

    def dim(self):
        return np.array([self.width, self.height], np.float64)

    def min(self):
        o = np.array(self.coords[3:5], np.float64)
        return np.minimum(o, o + np.array(self.scale[:2]) * self.dim())

    def max(self):
        o = np.array(self.coords[3:5], np.float64)
        return np.maximum(o, o + np.array(self.scale[:2]) * self.dim())


class geotiff(tiff):
    def __init__(self, source=None):
        self.meta = geotiff_meta()
        super().__init__(source)
        if source is not None and not isinstance(source, (str, bytes)):
            # geotiff-from-tensor: tie-point origin = shape (geotiff.hpp:71-75)
            self.meta.width = self.width
            self.meta.height = self.height
            self.meta.coords[3] = self._array.shape[0]
            self.meta.coords[4] = self._array.shape[1]

    # -- I/O -----------------------------------------------------------------

    def peek(self, filename: str) -> bool:
        super().peek(filename)
        self._load_meta()
        return True

    def read(self, filename: str) -> bool:
        super().read(filename)
        self._load_meta()
        self._set_nan()
        return True

    def _load_meta(self):
        info = self._info
        m = self.meta
        m.filename = self.filename or ""
        m.width = info.width
        m.height = info.height
        m.bits = info.bits
        tags = info.tags
        if TAG_GDAL_NODATA in tags:
            m.gdal_nodata = tags[TAG_GDAL_NODATA]
        if TAG_GDAL_METADATA in tags:
            m.gdal_metadata = tags[TAG_GDAL_METADATA]
        if TAG_GEOASCIIPARAMS in tags:
            m.geoasciiparams = tags[TAG_GEOASCIIPARAMS]
        if TAG_GEOPIXELSCALE in tags:
            m.scale = list(tags[TAG_GEOPIXELSCALE])
            if len(m.scale) > 2 and m.scale[2] == 0.0:
                m.scale[2] = 1.0  # io/geotiff.hpp:167-168
        if TAG_GEOTIEPOINTS in tags:
            m.coords = list(tags[TAG_GEOTIEPOINTS])
        if TAG_GEODOUBLEPARAMS in tags:
            m.params = list(tags[TAG_GEODOUBLEPARAMS])
        if TAG_GEOKEYDIRECTORY in tags:
            m.keydir = list(tags[TAG_GEOKEYDIRECTORY])
        if TAG_GEOTRANSMATRIX in tags:
            m.matrix = list(tags[TAG_GEOTRANSMATRIX])
        if TAG_INTERGRAPH_MATRIX in tags:
            m.intergraph = list(tags[TAG_INTERGRAPH_MATRIX])

    def _extra_tags(self):
        """Re-emit all geo tags on write (io/geotiff.hpp:210-226)."""
        m = self.meta
        tags = []
        if m.scale:
            tags.append((TAG_GEOPIXELSCALE, tiffcore.T_DOUBLE, tuple(m.scale)))
        if m.coords:
            tags.append((TAG_GEOTIEPOINTS, tiffcore.T_DOUBLE, tuple(m.coords)))
        if m.params:
            tags.append((TAG_GEODOUBLEPARAMS, tiffcore.T_DOUBLE, tuple(m.params)))
        if m.keydir:
            tags.append((TAG_GEOKEYDIRECTORY, tiffcore.T_SHORT, tuple(int(k) for k in m.keydir)))
        if m.matrix:
            tags.append((TAG_GEOTRANSMATRIX, tiffcore.T_DOUBLE, tuple(m.matrix)))
        if m.intergraph:
            tags.append((TAG_INTERGRAPH_MATRIX, tiffcore.T_DOUBLE, tuple(m.intergraph)))
        if m.gdal_nodata:
            tags.append((TAG_GDAL_NODATA, tiffcore.T_ASCII, m.gdal_nodata))
        if m.gdal_metadata:
            tags.append((TAG_GDAL_METADATA, tiffcore.T_ASCII, m.gdal_metadata))
        if m.geoasciiparams:
            tags.append((TAG_GEOASCIIPARAMS, tiffcore.T_ASCII, m.geoasciiparams))
        return tags

    # -- nodata <-> NaN (io/geotiff.hpp:243-314) -------------------------------

    def _set_nan(self):
        if not self.meta.gdal_nodata:
            return
        nodata = float(self.meta.gdal_nodata)
        arr = np.asarray(self._array)
        if arr.dtype.kind == "f":
            arr = arr.copy()
            arr[arr == nodata] = np.nan
            self._array = arr

    def unsetnan(self):
        """NaN -> nodata before write (binding name, io.cpp:53)."""
        if not self.meta.gdal_nodata:
            return
        nodata = float(self.meta.gdal_nodata)
        arr = np.asarray(self._array)
        if arr.dtype.kind == "f":
            arr = arr.copy()
            arr[np.isnan(arr)] = nodata
            self._array = arr

    unsetNaN = unsetnan

    # -- Projection helpers (io/geotiff.hpp:109-116) ---------------------------

    @property
    def scale(self):
        return np.array(self.meta.scale[:2], np.float64)

    def dim(self):
        return np.array([self.width, self.height], np.float64)

    @property
    def min(self):
        o = np.array(self.meta.coords[3:5], np.float64)
        return np.minimum(o, o + self.scale * self.dim())

    @property
    def max(self):
        o = np.array(self.meta.coords[3:5], np.float64)
        return np.maximum(o, o + self.scale * self.dim())

    def map(self, p):
        return self.min + self.scale * np.asarray(p, np.float64)

    # legacy example surface (dem_process.py:18)
    @property
    def index(self):
        return (self.height, self.width)
