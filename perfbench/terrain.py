"""The cells' terrains: FastNoiseLite 3-D OpenSimplex2 FBm (the upstream
soillib's `soil.noise`, whose defaults are frequency 1, 8 octaves, gain
0.6, lacunarity 2, lattice seed 1337) sampled at (x/ext.x, y/ext.y, z),
evaluated as one whole-grid torch program on the device.

A frozen copy of the measured program's FastNoiseLite field, so that the
relief, and with it the work of the adaptive exit, stays comparable to
the program's own records; the program may change, this may not.
Integers are held in int64 and wrapped to 32 bits explicitly.

How `--seed` varies a terrain is the traffic mix's `terrain` setting:
"slice" samples the noise at another z (a statistically equal relief,
other data); "fixed" keeps the configuration's own terrain for every seed
(where the terrain sets the work, as the adaptive exit's rounds: flips of
one terrain were measured to change them).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_2P31 = 1 << 31
_PRIME_X = 501125321
_PRIME_Y = 1136930381
_PRIME_Z = 1720413743
_HASH_MUL = 0x27D4EB2D


def _wrap_i32(x):
    return ((x + _2P31) & _M32) - _2P31


def _div(a, b: float):
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _grad_components(gi):
    """The 64-entry gradient table at gi, decoded arithmetically."""
    t = gi - 60
    m_tail = torch.where(
        t == 0, 8, torch.where(t == 1, 1, torch.where(t == 2, 9, 3)))
    m = torch.where(gi < 60, gi % 12, m_tail)
    g2 = m >> 2
    s0 = (1 - ((m & 1) << 1)).to(torch.float32)
    s1 = (1 - (m & 2)).to(torch.float32)
    zero = torch.zeros_like(s0)
    gx = torch.where(g2 == 0, zero, s0)
    gy = torch.where(g2 == 0, s0, torch.where(g2 == 2, s1, zero))
    gz = torch.where(g2 == 2, zero, s1)
    return gx, gy, gz


def _grad(seed: int, i, j, k, xd, yd, zd):
    h = _wrap_i32((seed ^ i ^ j ^ k) * _HASH_MUL)
    h = h ^ (h >> 15)
    gx, gy, gz = _grad_components((h >> 2) & 63)
    return gx * xd + gy * yd + gz * zd


def _fast_round(f):
    return torch.where(f >= 0.0, (f + 0.5).to(torch.int64),
                       (f - 0.5).to(torch.int64))


def opensimplex2(x, y, z, seed: int):
    """FastNoiseLite `SingleOpenSimplex2` at rotated coordinates."""
    seed = int(np.int32(seed))
    i = _fast_round(x)
    j = _fast_round(y)
    k = _fast_round(z)
    x0 = x - i.to(torch.float32)
    y0 = y - j.to(torch.float32)
    z0 = z - k.to(torch.float32)
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
            a > 0.0, (a * a) * (a * a) * _grad(seed, i, j, k, x0, y0, z0),
            0.0)
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
            (b * b) * (b * b) * _grad(seed, i1, j1, k1, x1, y1, z1), 0.0)
        if l == 1:
            break
        ax0 = 0.5 - ax0
        ay0 = 0.5 - ay0
        az0 = 0.5 - az0
        x0 = xns.to(torch.float32) * ax0
        y0 = yns.to(torch.float32) * ay0
        z0 = zns.to(torch.float32) * az0
        a = a + ((0.75 - ax0) - (ay0 + az0))
        i = _wrap_i32(i + ((xns >> 1) & _PRIME_X))
        j = _wrap_i32(j + ((yns >> 1) & _PRIME_Y))
        k = _wrap_i32(k + ((zns >> 1) & _PRIME_Z))
        xns, yns, zns = -xns, -yns, -zns
        seed = ~seed
    return value * float(np.float32(32.69428253173828125))


def fbm(x, y, z, seed=1337, octaves=8, gain=0.6, lacunarity=2.0,
        frequency=1.0):
    """FastNoiseLite FBm of OpenSimplex2 with the DefaultOpenSimplex2
    rotation and fractal bounding."""
    f = float(np.float32(frequency))
    x, y, z = x * f, y * f, z * f
    r = (x + y + z) * float(np.float32(2.0 / 3.0))
    xr, yr, zr = r - x, r - y, r - z
    gain = np.float32(abs(gain))
    amp_fractal = np.float32(1.0)
    amp = gain
    for _ in range(1, int(octaves)):
        amp_fractal += amp
        amp *= gain
    amp = np.float32(np.float32(1.0) / amp_fractal)
    total = torch.zeros_like(xr)
    lac = float(np.float32(lacunarity))
    for o in range(int(octaves)):
        total = total + opensimplex2(xr, yr, zr, int(seed) + o) * float(amp)
        xr, yr, zr = xr * lac, yr * lac, zr * lac
        amp = np.float32(amp * gain)
    return total


def noise(shape, ext, z, device):
    """The (W, H) float32 noise field at (x/ext[0], y/ext[1], z)."""
    W, H = int(shape[0]), int(shape[1])
    x = _div(torch.arange(W, dtype=torch.float32, device=device),
             float(np.float32(ext[0])))[:, None].expand(W, H)
    y = _div(torch.arange(H, dtype=torch.float32, device=device),
             float(np.float32(ext[1])))[None, :].expand(W, H)
    zz = torch.full((W, H), float(np.float32(z)), dtype=torch.float32,
                    device=device)
    return fbm(x, y, zz)


def _mix(seed: int, salt: int) -> int:
    """64 well-mixed bits of (seed, salt) (splitmix64)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + salt) & ((1 << 64) - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return x ^ (x >> 31)


def height(cfg_terrain: dict, variation: str, shape, seed: int, device):
    """The cell's initial height (W, H), float32 on `device`:
    amplitude * noise + offset, varied by `seed` as `variation` says."""
    z = float(cfg_terrain["z"])
    if variation == "slice":
        # z in [0, 256) in steps of 2^-16: a noise slice of its own.
        z += (_mix(seed, 1) >> 40) / 65536.0
    elif variation != "fixed":
        raise ValueError(f"unknown terrain variation {variation!r}")
    h = noise(shape, cfg_terrain["ext"], z, device)
    return h * float(cfg_terrain["amplitude"]) + float(cfg_terrain["offset"])


def sim_seed(seed: int) -> int:
    """The seed handed to the program's particle generator, in [0, 2^32)."""
    return _mix(seed, 3) >> 32
