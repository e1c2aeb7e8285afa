"""Procedural fractal noise (counterpart of `soillib_tpu/ops/noise.py`).

The reference samples FastNoiseLite OpenSimplex2 FBm on the CPU, one cell
at a time, at coordinates (x/ext.x, y/ext.y, seed): the seed rides in as
the third noise coordinate. Parameter defaults match noise_param_t:
frequency=1, octaves=8, gain=0.6, lacunarity=2, ext=(512, 512).

Two evaluation modes, both whole-grid torch programs (no per-cell loop),
on the card unless the caller asks for the CPU:

* `compat=True` (default): the FastNoiseLite 3-D OpenSimplex2 FBm
  pipeline (int32 prime-hash lattice, the two offset rotated cube grids,
  the DefaultOpenSimplex2 rotation, FBm with a per-octave seed increment
  and fractal bounding), matching the vendored library to float32
  roundoff, so the reference example terrains (erosion_gpu.py's seed-3
  DEM) are reproduced field for field.
* `compat=False`: a leaner simplex-lattice FBm with a counter-based hash;
  same parameter semantics, not bit-compatible with FastNoiseLite.

Integer arithmetic. The lattice hashes rely on wrapping 32-bit products
and shifts. Every integer here is held in int64 and wrapped explicitly:
`_wrap_i32` for the signed hash of the compat path (so `>>` stays an
arithmetic shift), `mul_u32` for the unsigned one (products formed from
16-bit halves, so no int64 product overflows). Float divisions go through
tensors on the operand's device, never a Python scalar divisor, which
torch on the card would turn into a multiply by the reciprocal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from soillib_tpu_torch.core.device import _device

_F3 = 1.0 / 3.0  # 3-D simplex skew factor
_G3 = 1.0 / 6.0  # 3-D simplex unskew factor

_M32 = 0xFFFFFFFF
_2P31 = 1 << 31

# 12 gradient directions: edge midpoints of a cube.
_GRAD3 = np.array(
    [
        [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    ],
    dtype=np.float32,
)


def mul_u32(a, b: int):
    """(a * b) mod 2^32 for an int64 tensor a holding values in
    [0, 2^32) and a constant b in [0, 2^32): the uint32 product, formed
    from b's 16-bit halves so that no int64 product overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _wrap_i32(x):
    """int64 tensor -> the int32 value it wraps to, sign-extended."""
    return ((x + _2P31) & _M32) - _2P31


def _div(a, b: float):
    """a / b in float32 as one true division (see the module docstring)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _hash3(i, j, k, seed: int):
    """Counter-based lattice hash -> uint32 (as int64), Murmur-style
    avalanche mix; i, j, k are int64 tensors of int32 values."""
    h = (mul_u32(i & _M32, 0x8DA6B343) + mul_u32(j & _M32, 0xD8163841)
         + mul_u32(k & _M32, 0xCB1AB31F)
         + (((seed & _M32) * 0x9E3779B9) & _M32)) & _M32
    h = h ^ (h >> 15)
    h = mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _grad_dot(i, j, k, seed, dx, dy, dz):
    """dot(gradient(lattice point), displacement)."""
    g = _hash3(i, j, k, seed) % 12
    tab = torch.as_tensor(_GRAD3, device=dx.device)
    return tab[:, 0][g] * dx + tab[:, 1][g] * dy + tab[:, 2][g] * dz


def simplex3(x, y, z, seed: int = 0):
    """Vectorized 3-D simplex noise in [-1, 1] (approx); x, y, z are
    float32 tensors of one shape."""
    s = (x + y + z) * _F3
    i = torch.floor(x + s).to(torch.int64)
    j = torch.floor(y + s).to(torch.int64)
    k = torch.floor(z + s).to(torch.int64)
    t = (i + j + k).to(torch.float32) * _G3
    x0 = x - (i.to(torch.float32) - t)
    y0 = y - (j.to(torch.float32) - t)
    z0 = z - (k.to(torch.float32) - t)

    # Rank the components to find the simplex traversal order.
    gx = (x0 >= y0).to(torch.int64) + (x0 >= z0).to(torch.int64)
    gy = (y0 > x0).to(torch.int64) + (y0 >= z0).to(torch.int64)
    gz = (z0 > x0).to(torch.int64) + (z0 > y0).to(torch.int64)
    i1, j1, k1 = (gx >= 2).long(), (gy >= 2).long(), (gz >= 2).long()
    i2, j2, k2 = (gx >= 1).long(), (gy >= 1).long(), (gz >= 1).long()

    x1 = x0 - i1 + _G3
    y1 = y0 - j1 + _G3
    z1 = z0 - k1 + _G3
    x2 = x0 - i2 + 2.0 * _G3
    y2 = y0 - j2 + 2.0 * _G3
    z2 = z0 - k2 + 2.0 * _G3
    x3 = x0 - 1.0 + 3.0 * _G3
    y3 = y0 - 1.0 + 3.0 * _G3
    z3 = z0 - 1.0 + 3.0 * _G3

    def corner(dx, dy, dz, ci, cj, ck):
        tt = 0.6 - dx * dx - dy * dy - dz * dz
        tt = torch.clamp(tt, min=0.0)
        return (tt * tt) * (tt * tt) * _grad_dot(ci, cj, ck, seed, dx, dy, dz)

    n = (
        corner(x0, y0, z0, i, j, k)
        + corner(x1, y1, z1, i + i1, j + j1, k + k1)
        + corner(x2, y2, z2, i + i2, j + j2, k + k2)
        + corner(x3, y3, z3, i + 1, j + 1, k + 1)
    )
    return 32.0 * n


# ---------------------------------------------------------------------------
# FastNoiseLite-compatible OpenSimplex2 (compat=True)
# ---------------------------------------------------------------------------

# Lattice hashing primes and the avalanche multiplier (FastNoiseLite).
_PRIME_X = 501125321
_PRIME_Y = 1136930381
_PRIME_Z = 1720413743
_HASH_MUL = 0x27D4EB2D

# 64-entry 3-D gradient table (FastNoiseLite Gradients3D): five repeats of
# the 12 cube-edge-midpoint directions, then a 4-entry tail (aliases of
# rows 8, 1, 9, 3). Kept for the decode test; `_os2_grad` decodes the
# components arithmetically, as the JAX package does.
_OS2_GRADS = np.array(
    [[0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
     [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
     [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0]] * 5
    + [[1, 1, 0], [0, -1, 1], [-1, 1, 0], [0, -1, -1]],
    dtype=np.float32,
)


def _os2_grad_components(gi):
    """(gx, gy, gz) float32 of the 64-entry gradient table at int64 index
    tensor gi, decoded arithmetically: row m of the 12 base directions
    zeroes axis m >> 2 and signs the other two by bits m & 1 and m & 2."""
    t = gi - 60
    m_tail = torch.where(
        t == 0, 8, torch.where(t == 1, 1, torch.where(t == 2, 9, 3)))
    m = torch.where(gi < 60, gi % 12, m_tail)
    g2 = m >> 2  # which axis is zero: 0 -> x, 1 -> y, 2 -> z
    s0 = (1 - ((m & 1) << 1)).to(torch.float32)
    s1 = (1 - (m & 2)).to(torch.float32)
    zero = torch.zeros_like(s0)
    gx = torch.where(g2 == 0, zero, s0)
    gy = torch.where(g2 == 0, s0, torch.where(g2 == 2, s1, zero))
    gz = torch.where(g2 == 2, zero, s1)
    return gx, gy, gz


def _os2_grad(seed: int, i, j, k, xd, yd, zd):
    """GradCoord: prime-XOR hash, avalanche multiply, arithmetic >> 15
    fold, 64-way gradient dot product, in wrapping int32 arithmetic."""
    h = _wrap_i32((seed ^ i ^ j ^ k) * _HASH_MUL)
    h = h ^ (h >> 15)
    gx, gy, gz = _os2_grad_components((h >> 2) & 63)
    return gx * xd + gy * yd + gz * zd


def _fast_round(f):
    """C-truncation round-half-away-from-zero ((int)(f +- 0.5f)); the
    cast truncates toward zero."""
    return torch.where(f >= 0.0, (f + 0.5).to(torch.int64),
                       (f - 0.5).to(torch.int64))


def opensimplex2(x, y, z, seed: int):
    """FastNoiseLite `SingleOpenSimplex2` 3-D noise, vectorized: the
    per-cell `for (l = 0;;)` loop runs exactly twice, so it is unrolled
    with the branchy axis selection turned into `where` masks. Inputs are
    rotation-transformed float32 tensors (see `_os2_transform`)."""
    seed = int(np.int32(seed))
    i = _fast_round(x)
    j = _fast_round(y)
    k = _fast_round(z)
    x0 = x - i.to(torch.float32)
    y0 = y - j.to(torch.float32)
    z0 = z - k.to(torch.float32)

    # xNSign = (int)(-1.0f - x0) | 1  ->  -1 where x0 >= 0 else +1.
    xns = torch.where(x0 >= 0.0, -1, 1)
    yns = torch.where(y0 >= 0.0, -1, 1)
    zns = torch.where(z0 >= 0.0, -1, 1)
    ax0 = xns.to(torch.float32) * -x0
    ay0 = yns.to(torch.float32) * -y0
    az0 = zns.to(torch.float32) * -z0

    i = _wrap_i32(i * _PRIME_X)
    j = _wrap_i32(j * _PRIME_Y)
    k = _wrap_i32(k * _PRIME_Z)

    value = torch.zeros_like(x0)
    a = (0.6 - x0 * x0) - (y0 * y0 + z0 * z0)

    for l in range(2):
        value = value + torch.where(
            a > 0.0, (a * a) * (a * a) * _os2_grad(seed, i, j, k, x0, y0, z0),
            0.0)

        # Second vertex: step along the largest-|displacement| axis
        # (ties resolved x-first then y, matching the if/else chain).
        pick_x = (ax0 >= ay0) & (ax0 >= az0)
        pick_y = ~pick_x & (ay0 > ax0) & (ay0 >= az0)
        pick_z = ~pick_x & ~pick_y
        xnsf = xns.to(torch.float32)
        ynsf = yns.to(torch.float32)
        znsf = zns.to(torch.float32)
        x1 = torch.where(pick_x, x0 + xnsf, x0)
        y1 = torch.where(pick_y, y0 + ynsf, y0)
        z1 = torch.where(pick_z, z0 + znsf, z0)
        b = a + 1.0
        b = torch.where(pick_x, b - xnsf * 2.0 * x1, b)
        b = torch.where(pick_y, b - ynsf * 2.0 * y1, b)
        b = torch.where(pick_z, b - znsf * 2.0 * z1, b)
        i1 = torch.where(pick_x, _wrap_i32(i - xns * _PRIME_X), i)
        j1 = torch.where(pick_y, _wrap_i32(j - yns * _PRIME_Y), j)
        k1 = torch.where(pick_z, _wrap_i32(k - zns * _PRIME_Z), k)
        value = value + torch.where(
            b > 0.0,
            (b * b) * (b * b) * _os2_grad(seed, i1, j1, k1, x1, y1, z1),
            0.0)

        if l == 1:
            break

        # Hop to the second (offset) cube grid.
        ax0 = 0.5 - ax0
        ay0 = 0.5 - ay0
        az0 = 0.5 - az0
        x0 = xns.to(torch.float32) * ax0
        y0 = yns.to(torch.float32) * ay0
        z0 = zns.to(torch.float32) * az0
        a = a + ((0.75 - ax0) - (ay0 + az0))
        # i += (xNSign >> 1) & PrimeX: adds the prime only on the -1 side.
        i = _wrap_i32(i + ((xns >> 1) & _PRIME_X))
        j = _wrap_i32(j + ((yns >> 1) & _PRIME_Y))
        k = _wrap_i32(k + ((zns >> 1) & _PRIME_Z))
        xns, yns, zns = -xns, -yns, -zns
        seed = ~seed

    return value * float(np.float32(32.69428253173828125))


def _os2_transform(x, y, z, frequency):
    """TransformNoiseCoordinate, TransformType3D_DefaultOpenSimplex2:
    frequency scale then the R3 rotation."""
    f = float(np.float32(frequency))
    x, y, z = x * f, y * f, z * f
    r = (x + y + z) * float(np.float32(2.0 / 3.0))
    return r - x, r - y, r - z


def opensimplex2_fbm(x, y, z, *, seed=1337, octaves=8, gain=0.6,
                     lacunarity=2.0, frequency=1.0):
    """FastNoiseLite `GetNoise` 3-D with FractalType_FBm + OpenSimplex2:
    the rotation runs once on the base coordinates; each octave
    increments the int seed and multiplies the transformed coordinates by
    the lacunarity in float32; amplitudes are gain^o scaled by the
    fractal bounding 1/sum(gain^o)."""
    xr, yr, zr = _os2_transform(x, y, z, frequency)
    gain = np.float32(abs(gain))
    amp_fractal = np.float32(1.0)
    amp = gain
    for _ in range(1, int(octaves)):
        amp_fractal += amp
        amp *= gain
    bounding = np.float32(1.0) / amp_fractal

    total = torch.zeros_like(xr)
    amp = np.float32(bounding)
    lac = float(np.float32(lacunarity))
    s = int(seed)
    for o in range(int(octaves)):
        total = total + opensimplex2(xr, yr, zr, s + o) * float(amp)
        xr, yr, zr = xr * lac, yr * lac, zr * lac
        amp = np.float32(amp * gain)
    return total


@dataclasses.dataclass
class noise_t:
    """Noise parameter set, field-compatible with noise_param_t.
    `compat=True` runs the FastNoiseLite OpenSimplex2 pipeline; `iseed` is
    FastNoiseLite's int lattice seed (default 1337); the float `seed` is
    the third noise coordinate."""

    frequency: float = 1.0
    octaves: int = 8
    gain: float = 0.6
    lacunarity: float = 2.0
    seed: float = 0.0
    ext: tuple = (512.0, 512.0)
    compat: bool = True
    iseed: int = 1337


def noise(shape, param: noise_t = None, device="cuda"):
    """FBm fractal noise over a (W, H) grid, sampled at (x/ext.x,
    y/ext.y, seed) like the reference's per-cell loop. With
    `param.compat` (default) the result equals the reference's
    `soil.noise` output to float32 roundoff.

    Returns a (W, H) float32 tensor on `device` (the card unless the
    caller passes device="cpu")."""
    if param is None:
        param = noise_t()
    dev = _device(device)
    W, H = int(shape[0]), int(shape[1])
    ext = param.ext
    x = _div(torch.arange(W, dtype=torch.float32, device=dev),
             float(np.float32(ext[0])))[:, None].expand(W, H)
    y = _div(torch.arange(H, dtype=torch.float32, device=dev),
             float(np.float32(ext[1])))[None, :].expand(W, H)

    if param.compat:
        z = torch.full((W, H), float(np.float32(param.seed)),
                       dtype=torch.float32, device=dev)
        return opensimplex2_fbm(
            x, y, z,
            seed=param.iseed,
            octaves=param.octaves,
            gain=param.gain,
            lacunarity=param.lacunarity,
            frequency=param.frequency,
        )

    z = torch.full((W, H), float(np.float32(param.seed)),
                   dtype=torch.float32, device=dev)
    total = torch.zeros((W, H), dtype=torch.float32, device=dev)
    amp = 1.0
    bounding = 0.0
    freq = float(param.frequency)
    # Octave index is folded into the hash seed so octaves decorrelate.
    for o in range(int(param.octaves)):
        total = total + amp * simplex3(x * freq, y * freq, z * freq,
                                       seed=o * 1013 + 7)
        bounding += amp
        amp *= float(param.gain)
        freq *= float(param.lacunarity)
    return _div(total, float(np.float32(bounding)))
