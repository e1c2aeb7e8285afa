"""Terrain triangulation -> PLY export (counterpart of
`soillib_tpu/io/mesh.py`; reference: io/mesh.hpp:33-135).

NaN-skipping vertex insertion with index remap, two triangles per quad,
min/max height normalization, `center()`, ascii (`write`) and binary
(`write_binary`) output on the host. Heights may be arrays or tensors on
any device. As in the JAX package, the triangulation and the binary
writer run in the native library (`soillib_tpu_torch.native`: the two
triangles of a quad interleaved, as the reference emits them) where it
builds, else vectorized with numpy (the triangles batched); the numpy
path's files are the same bytes as the JAX package's numpy writer's.
"""

from __future__ import annotations

import numpy as np

from soillib_tpu_torch import native
from soillib_tpu_torch.io.tiff import _host

# One binary face record: the vertex count and three vertex indices,
# little-endian and packed (13 bytes).
_FACE = np.dtype([("n", "<u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])


def _native_triangulate(h, scale):
    """The native triangulation; None falls back to numpy."""
    return native.triangulate(h, scale)


def _native_ply(path, vertices, faces):
    """The native binary PLY writer; False falls back to numpy."""
    return native.ply_write(path, vertices, faces, binary=True)


class mesh:
    def __init__(self, tensor=None, scale=(1.0, 1.0, 1.0)):
        self.vertices = np.zeros((0, 3), np.float32)
        self.faces = np.zeros((0, 3), np.int32)
        if tensor is not None:
            self._triangulate(_host(tensor).astype(np.float32, copy=False),
                              scale)

    def _triangulate(self, h: np.ndarray, scale):
        out = _native_triangulate(h, scale)
        if out is not None:
            self.vertices, self.faces = out
            return
        W, H = h.shape
        sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])

        # Height normalization to [0, 1] (io/mesh.hpp min/max normalize).
        hmin = np.nanmin(h)
        hmax = np.nanmax(h)
        hn = (h - hmin) / (hmax - hmin) if hmax > hmin else np.zeros_like(h)

        # Vertex index remap: -1 where NaN.
        flat_valid = ~np.isnan(h).reshape(-1)
        remap = np.full(W * H, -1, np.int64)
        remap[flat_valid] = np.arange(flat_valid.sum())

        xs, ys = np.meshgrid(np.arange(W), np.arange(H), indexing="ij")
        verts = np.stack(
            [xs.reshape(-1) * sx, ys.reshape(-1) * sy, hn.reshape(-1) * sz],
            axis=-1,
        )[flat_valid].astype(np.float32)

        # Two triangles per quad where all four corners are valid.
        i00 = (xs[:-1, :-1] * H + ys[:-1, :-1]).reshape(-1)
        i10 = i00 + H
        i01 = i00 + 1
        i11 = i00 + H + 1
        q = (
            flat_valid[i00] & flat_valid[i10] & flat_valid[i01]
            & flat_valid[i11]
        )
        t1 = np.stack([remap[i00], remap[i10], remap[i11]], axis=-1)[q]
        t2 = np.stack([remap[i00], remap[i11], remap[i01]], axis=-1)[q]
        self.vertices = verts
        self.faces = np.concatenate([t1, t2], axis=0).astype(np.int32)

    def center(self):
        """Translate vertices so the bounding box is centered at the origin."""
        if len(self.vertices):
            mid = 0.5 * (self.vertices.min(0) + self.vertices.max(0))
            self.vertices = self.vertices - mid
        return self

    def write(self, filename: str) -> bool:
        """ASCII PLY."""
        with open(filename, "w") as f:
            f.write(self._header(ascii=True))
            for v in self.vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
            for t in self.faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
        return True

    def write_binary(self, filename: str) -> bool:
        """Binary little-endian PLY: the faces as one packed record array."""
        if _native_ply(filename, self.vertices, self.faces):
            return True
        faces = np.empty(len(self.faces), _FACE)
        faces["n"] = 3
        faces["a"], faces["b"], faces["c"] = np.asarray(self.faces).T
        with open(filename, "wb") as f:
            f.write(self._header(ascii=False).encode("ascii"))
            f.write(self.vertices.astype("<f4").tobytes())
            f.write(faces.tobytes())
        return True

    def _header(self, ascii: bool) -> str:
        fmt = "ascii 1.0" if ascii else "binary_little_endian 1.0"
        return (
            "ply\n"
            f"format {fmt}\n"
            f"element vertex {len(self.vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(self.faces)}\n"
            "property list uchar int vertex_indices\n"
            "end_header\n"
        )
