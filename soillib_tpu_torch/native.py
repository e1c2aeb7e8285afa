"""Native (C++) host runtime — ctypes bindings over the port's own copy
of the JAX package's native source (`csrc/native.cpp`), built on first
use (counterpart of `soillib_tpu/native/__init__.py`).

It holds the host-side hot paths of the I/O layer: LZW and PackBits
decompression (the Python-loop-bound parts of io/tiffcore.py),
heightfield triangulation and PLY emission, and threaded FBm noise.
These are CPU work in the JAX package too; nothing here runs on the card.

The library is compiled once with g++ into `_build/`, under a name that
carries a hash of the source and flags, through a temporary file moved
into place (`os.replace`): processes that build at the same time each
write their own file and none loads a half-written one. Every caller
falls back to the pure-Python path when the toolchain or the library is
unavailable (`available()` says which is active, `build_error()` why
the build failed). Nothing is built or loaded when the module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "csrc", "native.cpp")
BUILD = os.path.join(_DIR, "_build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
_error = None


def _library_path() -> str:
    """Where the library for this source and these flags lives."""
    with open(SRC, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(BUILD, f"libsoilnative-{h[:12]}.so")


def _build(lib: str):
    """Compile SRC into `lib`; None, or the reason it failed."""
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD, prefix=".libsoilnative.",
                               suffix=".so")
    os.close(fd)
    try:
        r = subprocess.run(["g++", *FLAGS, "-o", tmp, SRC, "-lpthread"],
                           capture_output=True, text=True, timeout=240)
        if r.returncode != 0:
            return f"g++ exited {r.returncode}: {r.stderr.strip()[-2000:]}"
        os.replace(tmp, lib)
        return None
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ could not run: {e}"
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib):
    i64, f32 = ctypes.c_int64, ctypes.c_float
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.soil_lzw_decode.restype = ctypes.c_longlong
    lib.soil_lzw_decode.argtypes = [u8p, ctypes.c_longlong, u8p,
                                    ctypes.c_longlong]
    lib.soil_packbits_decode.restype = ctypes.c_longlong
    lib.soil_packbits_decode.argtypes = [u8p, ctypes.c_longlong, u8p,
                                         ctypes.c_longlong]
    lib.soil_tri_count.restype = None
    lib.soil_tri_count.argtypes = [f32p, i64, i64, i64p, i64p]
    lib.soil_triangulate.restype = None
    lib.soil_triangulate.argtypes = [f32p, i64, i64, f32, f32, f32, f32p,
                                     i32p]
    lib.soil_ply_write.restype = ctypes.c_int
    lib.soil_ply_write.argtypes = [ctypes.c_char_p, f32p, i64, i32p, i64,
                                   ctypes.c_int]
    lib.soil_fbm2.restype = None
    lib.soil_fbm2.argtypes = [f32p, i64, i64, f32, f32, f32, ctypes.c_int,
                              f32, f32, f32]
    return lib


def _load():
    """The loaded library, building it first if needed; None when it is
    unavailable (the reason in `build_error()`)."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = _library_path()
        if not os.path.exists(lib):
            _error = _build(lib)
            if _error is not None:
                return None
        try:
            _lib = _declare(ctypes.CDLL(lib))
        except OSError as e:
            _error = f"could not load {lib}: {e}"
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it now if
    it was not tried yet)."""
    return _load() is not None


def build_error():
    """Why the library is unavailable, or None."""
    _load()
    return _error


def _u8(buf):
    return (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)


def _decode(fn, data: bytes, expected: int):
    out = np.empty(expected, np.uint8)
    n = fn(_u8(data), len(data),
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected)
    return None if n < 0 else out[:n].tobytes()


def lzw_decode(data: bytes, expected: int):
    """TIFF LZW decode of at most `expected` bytes; None if the library
    is unavailable or the stream is malformed (the Python decoder then
    decides, and names the fault)."""
    lib = _load()
    return None if lib is None else _decode(lib.soil_lzw_decode, data,
                                            expected)


def packbits_decode(data: bytes, expected: int):
    """TIFF PackBits decode; None as `lzw_decode`."""
    lib = _load()
    return None if lib is None else _decode(lib.soil_packbits_decode, data,
                                            expected)


def triangulate(h: np.ndarray, scale):
    """(vertices, faces) like io/mesh.hpp:49-118 (the two triangles of a
    quad interleaved, as the reference emits them); None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = np.ascontiguousarray(h, np.float32)
    W, H = h.shape
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    hp = h.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.soil_tri_count(hp, W, H, ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    lib.soil_triangulate(
        hp, W, H, float(scale[0]), float(scale[1]), float(scale[2]),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return verts, faces


def ply_write(path: str, vertices: np.ndarray, faces: np.ndarray,
              binary: bool) -> bool:
    """Write a PLY file; False if the library is unavailable or the file
    could not be opened."""
    lib = _load()
    if lib is None:
        return False
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    rc = lib.soil_ply_write(
        path.encode(), v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(v), f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(f),
        1 if binary else 0,
    )
    return rc == 0


def fbm2(shape, ext, frequency, octaves, gain, lacunarity, z):
    """Threaded CPU FBm with ops/noise.py's lattice hash and gradients
    (equal to `noise` on all but a few cells where rounding flips the
    simplex corner); None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    W, H = int(shape[0]), int(shape[1])
    out = np.empty((W, H), np.float32)
    lib.soil_fbm2(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), W, H,
        1.0 / float(ext[0]), 1.0 / float(ext[1]), float(frequency),
        int(octaves), float(gain), float(lacunarity), float(z),
    )
    return out
