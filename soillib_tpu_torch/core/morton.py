"""Z-order (Morton) curve indexing (counterpart of
`soillib_tpu/core/morton.py`): branch-free bit interleaving of 16-bit
coordinates.

torch supports few bit operations on uint32, so the interleaving runs in
int64 masked to 32 bits. `encode2` returns torch.uint32 codes and
`decode2` int32 coordinates, the dtypes the JAX package returns. Inputs
are tensors (kept on their device) or array-likes, which go to `device`:
the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import torch

from soillib_tpu_torch.core.device import as_field

_MASK32 = 0xFFFFFFFF


def _u32(x, device):
    """x as int64 holding its uint32 value (negative ints wrap as a cast
    to uint32 does)."""
    return as_field(x, device, dtype=None).to(torch.int64) & _MASK32


def _part1by1(x):
    """Spread the low 16 bits of x into the even bit positions."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _compact1by1(x):
    """Inverse of _part1by1: gather even bit positions into the low 16."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def encode2(x, y, device=None):
    """(x, y) int arrays -> torch.uint32 Morton codes (x in even bits)."""
    x = _u32(x, device)
    y = _u32(y, x.device).to(x.device)
    return (_part1by1(x) | (_part1by1(y) << 1)).to(torch.uint32)


def decode2(code, device=None):
    """Morton codes (uint32, or any integer dtype read as uint32) ->
    (x, y) int32 tensors."""
    c = _u32(code, device)
    return (_compact1by1(c).to(torch.int32),
            _compact1by1(c >> 1).to(torch.int32))
