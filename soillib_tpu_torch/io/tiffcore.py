"""Minimal self-contained TIFF codec (numpy in/out); a copy of
`soillib_tpu/io/tiffcore.py`. LZW and PackBits strips decode through the
native library (`soillib_tpu_torch.native`, the port's copy of the JAX
package's C++ decoders) where it builds, else through the pure-Python
decoders here, which also name the fault of a malformed stream.

Replaces the reference's libtiff dependency (io/tiff.hpp) for the formats a
DEM pipeline needs:

  read:  little/big endian classic TIFF; strip AND tile organization
         (io/tiff.hpp:100-214 handles both); 8/16/32/64-bit unsigned/signed/
         IEEE-FP samples; compression none / PackBits / Deflate(+zlib) / LZW;
         predictor 1 (none) and 2 (horizontal differencing).
  write: uncompressed strip float32/float64 (+ int) scanlines, plus
         arbitrary extra tags (used by the GeoTIFF layer).

Intentionally not supported (like the reference): BigTIFF, JPEG compression,
planar-separate multi-sample images.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from soillib_tpu_torch import native

# TIFF data types -> (struct fmt, bytes)
_TYPES = {
    1: ("B", 1),   # BYTE
    2: ("s", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("I", 4),   # LONG
    5: ("II", 8),  # RATIONAL
    6: ("b", 1),   # SBYTE
    8: ("h", 2),   # SSHORT
    9: ("i", 4),   # SLONG
    10: ("ii", 8),  # SRATIONAL
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
}

T_ASCII = 2
T_SHORT = 3
T_LONG = 4
T_FLOAT = 11
T_DOUBLE = 12

# Tag ids
TAG_WIDTH = 256
TAG_LENGTH = 257
TAG_BITS = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_ORIENTATION = 274
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTECOUNTS = 279
TAG_PLANAR = 284
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTECOUNTS = 325
TAG_SAMPLE_FORMAT = 339

SAMPLEFORMAT_UINT = 1
SAMPLEFORMAT_INT = 2
SAMPLEFORMAT_IEEEFP = 3


def _unpack_lzw(data: bytes) -> bytes:
    """TIFF-variant LZW decoder (MSB-first codes, early code change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = None
    bitpos = 0
    nbits = 9
    prev = None
    data_len = len(data) * 8

    def read_code():
        nonlocal bitpos
        if bitpos + nbits > data_len:
            return EOI
        byte0 = bitpos // 8
        avail = bytes(data[byte0 : byte0 + 4]).ljust(4, b"\0")
        word = struct.unpack(">I", avail)[0]
        shift = 32 - (bitpos % 8) - nbits
        code = (word >> shift) & ((1 << nbits) - 1)
        bitpos += nbits
        return code

    while True:
        code = read_code()
        if code == EOI:
            break
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            nbits = 9
            prev = None
            continue
        if table is None:
            raise ValueError("LZW stream does not start with CLEAR")
        if prev is None:
            if code >= len(table):
                raise ValueError(f"corrupt LZW stream: code {code} before any string")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            # KwKwK: the only legal not-yet-defined code is the next slot.
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(
                f"corrupt LZW stream: code {code} beyond next table slot {len(table)}"
            )
        out += entry
        prev = entry
        # TIFF early change: bump width one code early.
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(out)


def _unpack_packbits(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        b = data[i]
        i += 1
        if b < 128:
            out += data[i : i + b + 1]
            i += b + 1
        elif b > 128:
            out += bytes([data[i]]) * (257 - b)
            i += 1
    return bytes(out)


def _decompress(data: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return data
    if compression in (8, 32946):  # Deflate / old deflate
        return zlib.decompress(data)
    if compression == 5:
        out = native.lzw_decode(data, expected)
        return out if out is not None else _unpack_lzw(data)
    if compression == 32773:
        out = native.packbits_decode(data, expected)
        return out if out is not None else _unpack_packbits(data, expected)
    raise ValueError(f"unsupported TIFF compression: {compression}")


class TiffInfo:
    """Parsed IFD of the first image in a TIFF file."""

    def __init__(self):
        self.width = 0
        self.height = 0
        self.bits = 32
        self.samples = 1
        self.sample_format = SAMPLEFORMAT_UINT
        self.compression = 1
        self.predictor = 1
        self.tiled = False
        self.tile_width = 0
        self.tile_length = 0
        self.tags = {}  # raw: tag id -> value tuple / bytes


def _read_ifd(f, endian: str):
    (count,) = struct.unpack(endian + "H", f.read(2))
    entries = {}
    for _ in range(count):
        tag, typ, n = struct.unpack(endian + "HHI", f.read(8))
        raw = f.read(4)
        if typ not in _TYPES:
            continue
        fmt, size = _TYPES[typ]
        total = size * n
        if total <= 4:
            data = raw[:total]
        else:
            (offset,) = struct.unpack(endian + "I", raw)
            pos = f.tell()
            f.seek(offset)
            data = f.read(total)
            f.seek(pos)
        if typ == T_ASCII:
            value = data.split(b"\0")[0].decode("latin-1")
        elif typ in (5, 10):
            vals = struct.unpack(endian + fmt * n, data)
            value = tuple(
                (vals[2 * i] / vals[2 * i + 1]) if vals[2 * i + 1] else 0.0
                for i in range(n)
            )
        else:
            value = struct.unpack(endian + fmt * n, data)
        entries[tag] = value
    (next_ifd,) = struct.unpack(endian + "I", f.read(4))
    return entries, next_ifd


def peek(path: str) -> TiffInfo:
    """Parse headers/tags of the first IFD without decoding pixel data."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic[:2] == b"II":
            endian = "<"
        elif magic[:2] == b"MM":
            endian = ">"
        else:
            raise ValueError(f"not a TIFF file: {path}")
        if struct.unpack(endian + "H", magic[2:4])[0] != 42:
            raise ValueError(f"not a classic TIFF (BigTIFF unsupported): {path}")
        (ifd_off,) = struct.unpack(endian + "I", f.read(4))
        f.seek(ifd_off)
        entries, _ = _read_ifd(f, endian)

    info = TiffInfo()
    info.tags = entries
    info.endian = endian
    info.width = entries.get(TAG_WIDTH, (0,))[0]
    info.height = entries.get(TAG_LENGTH, (0,))[0]
    info.bits = entries.get(TAG_BITS, (32,))[0]
    info.samples = entries.get(TAG_SAMPLES_PER_PIXEL, (1,))[0]
    info.sample_format = entries.get(TAG_SAMPLE_FORMAT, (SAMPLEFORMAT_UINT,))[0]
    info.compression = entries.get(TAG_COMPRESSION, (1,))[0]
    info.predictor = entries.get(TAG_PREDICTOR, (1,))[0]
    info.tiled = TAG_TILE_OFFSETS in entries
    if info.tiled:
        info.tile_width = entries.get(TAG_TILE_WIDTH, (0,))[0]
        info.tile_length = entries.get(TAG_TILE_LENGTH, (0,))[0]
    return info


def _dtype_of(info: TiffInfo):
    byte = info.bits // 8
    if info.sample_format == SAMPLEFORMAT_IEEEFP:
        return {2: np.float16, 4: np.float32, 8: np.float64}[byte]
    if info.sample_format == SAMPLEFORMAT_INT:
        return {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[byte]
    return {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[byte]


def _apply_predictor(block: np.ndarray, predictor: int):
    if predictor == 2:
        np.cumsum(block, axis=-2 if block.ndim == 3 else 1, dtype=block.dtype, out=block)
    return block


def read(path: str):
    """Read first image -> (array (H, W) or (H, W, S), TiffInfo)."""
    info = peek(path)
    if info.samples > 1 and info.tags.get(TAG_PLANAR, 1) == 2:
        # Planar-separate is intentionally unsupported (module docstring);
        # decoding it as chunky would silently scramble the bands.
        raise ValueError(
            "planar-separate (PlanarConfiguration=2) TIFFs are not supported"
        )
    endian = info.endian
    dtype = np.dtype(_dtype_of(info)).newbyteorder(endian)
    H, W, S = info.height, info.width, info.samples
    out = np.zeros((H, W, S), dtype=np.dtype(_dtype_of(info)))

    with open(path, "rb") as f:
        if info.tiled:
            tw, tl = info.tile_width, info.tile_length
            offs = info.tags[TAG_TILE_OFFSETS]
            cnts = info.tags.get(TAG_TILE_BYTECOUNTS, None)
            tiles_across = (W + tw - 1) // tw
            expected = tw * tl * S * dtype.itemsize
            for t, off in enumerate(offs):
                f.seek(off)
                nbytes = cnts[t] if cnts else expected
                raw = _decompress(f.read(nbytes), info.compression, expected)
                tile = np.frombuffer(raw[:expected], dtype=dtype).reshape(tl, tw, S)
                tile = _apply_predictor(tile.copy(), info.predictor)
                ty, tx = divmod(t, tiles_across)
                y0, x0 = ty * tl, tx * tw
                ys, xs = min(tl, H - y0), min(tw, W - x0)
                if ys > 0 and xs > 0:
                    out[y0 : y0 + ys, x0 : x0 + xs] = tile[:ys, :xs]
        else:
            offs = info.tags[TAG_STRIP_OFFSETS]
            cnts = info.tags.get(TAG_STRIP_BYTECOUNTS, None)
            rps = info.tags.get(TAG_ROWS_PER_STRIP, (H,))[0]
            rps = min(rps, H)
            for si, off in enumerate(offs):
                y0 = si * rps
                rows = min(rps, H - y0)
                expected = rows * W * S * dtype.itemsize
                f.seek(off)
                nbytes = cnts[si] if cnts else expected
                raw = _decompress(f.read(nbytes), info.compression, expected)
                strip = np.frombuffer(raw[:expected], dtype=dtype).reshape(rows, W, S)
                strip = _apply_predictor(strip.copy(), info.predictor)
                out[y0 : y0 + rows] = strip

    if S == 1:
        out = out[..., 0]
    return out, info


def write(path: str, array: np.ndarray, extra_tags=None):
    """Write (H, W) or (H, W, S) array as an uncompressed strip TIFF.

    extra_tags: list of (tag_id, tiff_type, values) appended to the IFD
    (sorted by tag id as required). ASCII values may be str.
    """
    arr = np.ascontiguousarray(array)
    if arr.ndim == 2:
        arr = arr[..., None]
    H, W, S = arr.shape
    dt = arr.dtype
    if dt.kind == "f":
        fmt = SAMPLEFORMAT_IEEEFP
    elif dt.kind == "i":
        fmt = SAMPLEFORMAT_INT
    elif dt.kind == "u":
        fmt = SAMPLEFORMAT_UINT
    else:
        raise ValueError(f"unsupported dtype: {dt}")
    bits = dt.itemsize * 8

    endian = "<"
    data = arr.astype(dt.newbyteorder(endian), copy=False).tobytes()

    tags = [
        (TAG_WIDTH, T_LONG, (W,)),
        (TAG_LENGTH, T_LONG, (H,)),
        (TAG_BITS, T_SHORT, (bits,) * S),
        (TAG_COMPRESSION, T_SHORT, (1,)),
        (TAG_PHOTOMETRIC, T_SHORT, (1,)),  # MinIsBlack
        (TAG_STRIP_OFFSETS, T_LONG, None),  # patched below
        (TAG_ORIENTATION, T_SHORT, (1,)),
        (TAG_SAMPLES_PER_PIXEL, T_SHORT, (S,)),
        (TAG_ROWS_PER_STRIP, T_LONG, (H,)),
        (TAG_STRIP_BYTECOUNTS, T_LONG, (len(data),)),
        (TAG_PLANAR, T_SHORT, (1,)),
        (TAG_SAMPLE_FORMAT, T_SHORT, (fmt,) * S),
    ]
    for tag_id, typ, vals in extra_tags or []:
        if isinstance(vals, str):
            vals = vals.encode("latin-1") + b"\0"
        tags.append((tag_id, typ, vals))
    tags.sort(key=lambda t: t[0])

    # Layout: header(8) | IFD | overflow values | pixel data
    n = len(tags)
    ifd_off = 8
    ifd_size = 2 + n * 12 + 4
    overflow_off = ifd_off + ifd_size

    # First pass: compute overflow sizes.
    overflow = []
    entries = []
    cursor = overflow_off
    for tag_id, typ, vals in tags:
        if tag_id == TAG_STRIP_OFFSETS:
            entries.append((tag_id, typ, 1, None))  # patched later
            continue
        fmt_ch, size = _TYPES[typ]
        if typ == T_ASCII:
            payload = vals if isinstance(vals, bytes) else bytes(vals)
            count = len(payload)
        else:
            payload = struct.pack(endian + fmt_ch * len(vals), *vals)
            count = len(vals)
        if len(payload) <= 4:
            entries.append((tag_id, typ, count, payload.ljust(4, b"\0")))
        else:
            entries.append((tag_id, typ, count, struct.pack(endian + "I", cursor)))
            overflow.append(payload)
            cursor += len(payload)

    data_off = cursor
    with open(path, "wb") as f:
        f.write(b"II" if endian == "<" else b"MM")
        f.write(struct.pack(endian + "H", 42))
        f.write(struct.pack(endian + "I", ifd_off))
        f.write(struct.pack(endian + "H", n))
        for tag_id, typ, count, payload in entries:
            if tag_id == TAG_STRIP_OFFSETS:
                payload = struct.pack(endian + "I", data_off)
                count = 1
            f.write(struct.pack(endian + "HHI", tag_id, typ, count))
            f.write(payload)
        f.write(struct.pack(endian + "I", 0))  # no next IFD
        for payload in overflow:
            f.write(payload)
        f.write(data)
