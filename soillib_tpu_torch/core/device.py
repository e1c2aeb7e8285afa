"""Where the port's entry points put their data: on the card unless the
caller asks for the CPU, never on the CPU as a silent fallback."""

from __future__ import annotations

import functools

import numpy as np
import torch


def _device(device) -> torch.device:
    """The requested device; a CUDA device without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the CPU"
        )
    return dev


def as_field(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """`x` as a tensor of `dtype`: a tensor stays on its own device;
    anything else (numpy, lists, scalars) goes to `device`, the card
    unless the caller passes device="cpu"."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    a = np.asarray(x)
    if not a.flags.writeable:  # torch warns on read-only numpy memory
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=_device(device or "cuda"))


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: every bit of the result depends on every
    bit of `x`."""
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def seeded_generator(device, seed: int = 0, offset: int = 0):
    """A torch.Generator on `device` seeded from (seed, offset) (each taken
    mod 2^32): the port's stand-in for the JAX package's
    `fold_in(PRNGKey(seed), offset)` keys and the reference's
    curand_init(seed, n, offset) streams. Deterministic in (seed,
    offset); not the same numbers as either. The 64-bit key `(seed << 32)
    | offset` is mixed before seeding, because the CPU's generator
    (mt19937) keeps only the low 32 bits of its seed: unmixed, every seed
    of one offset drew the same numbers there."""
    key = ((int(seed) & 0xFFFFFFFF) << 32) | (int(offset) & 0xFFFFFFFF)
    return torch.Generator(device=_device(device)).manual_seed(_mix64(key))


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant tensor of `values` on `device`, made once and
    shared by every caller, who must not write it. A tensor made from host
    data is a copy from the host, which a CUDA-graph capture refuses, so
    the step's constants come from here, made on its first (eager) call."""
    return torch.tensor(values, dtype=dtype, device=device)
