"""The particle births' generator, worked out from the seed the benchmark
hands the program (`ErosionSim(seed=...)`): a torch.Generator seeded with
splitmix64's finalizer of the 64-bit key (seed mod 2^32) << 32, as the
measured program documents its `seeded_generator(device, seed)`."""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


def mix64(x: int) -> int:
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def generator(device, seed: int) -> torch.Generator:
    key = (int(seed) & 0xFFFFFFFF) << 32
    return torch.Generator(device=device).manual_seed(mix64(key))
