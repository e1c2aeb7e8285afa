"""`silt` compatibility surface — the reference's tensor core, on torch
tensors (counterpart of `soillib_tpu/silt.py`).

The reference's buffer layer is the separate `silt` package (dtypes,
`silt.tensor`, `silt.shape`, hosts, elementwise ops, RNG seeding). Here
`torch.Tensor` is the tensor core; this module lets reference-style
scripts (`silt.tensor(...)`, e.g. example/erosion_gpu.py:18,
dem_process.py:72-82) port with few edits:

    from soillib_tpu_torch import silt
    t = silt.tensor(silt.float32, silt.shape(512, 512), silt.gpu)
    t = silt.set(t, 1.0)            # functional: returns the new tensor
    arr = t.numpy()

As in the JAX package, the ops are functional: they return new tensors
instead of mutating. `silt.gpu` is the card and the default host; an
`rng` tensor holds a torch.Generator (seeded from 0), and `seed(t, seed,
offset)` returns a fresh one on the tensor's device, deterministic in
(seed, offset) like the reference's curand_init streams
(graph.cu:97-101), though not the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from soillib_tpu_torch.core.device import _device, seeded_generator
from soillib_tpu_torch.core.grid import Shape as shape  # noqa: F401
from soillib_tpu_torch.ops.resize import copy, resize  # noqa: F401

# dtype enumerators (io/tiff.hpp:33-37; op/noise.hpp usage)
float32 = torch.float32
float64 = torch.float64
int32 = torch.int32


class _RngDtype:
    """Marker for RNG-state tensors (`silt.rng`, erosion.hpp:81)."""

    def __repr__(self):
        return "silt.rng"


rng = _RngDtype()


class _Host:
    def __init__(self, name, device):
        self.name, self.device = name, device

    def __repr__(self):
        return f"silt.{self.name}"


cpu = _Host("cpu", "cpu")
gpu = _Host("gpu", "cuda")


class tensor:
    """Thin wrapper matching the silt python tensor surface: `array` is
    the torch tensor (for `rng`, a torch.Generator of `dims`)."""

    def __init__(self, dtype=float32, shp=None, host=None):
        if shp is None:
            raise ValueError("tensor(dtype, shape, host)")
        dims = tuple(int(d) for d in shp)
        dev = _device((host or gpu).device)
        self.dims = dims
        self.dtype = dtype
        if isinstance(dtype, _RngDtype):
            self.array = seeded_generator(dev)
        else:
            self.array = torch.zeros(dims, dtype=dtype, device=dev)

    @staticmethod
    def from_numpy(arr):
        return tensor._wrap(torch.from_numpy(np.array(arr)))

    @staticmethod
    def _wrap(arr, dtype=None):
        t = tensor.__new__(tensor)
        t.array = arr
        t.dtype = dtype if dtype is not None else arr.dtype
        t.dims = tuple(arr.shape) if isinstance(arr, torch.Tensor) else ()
        return t

    def _to(self, device):
        if isinstance(self.dtype, _RngDtype):
            out = tensor._wrap(seeded_generator(device), rng)
            out.dims = self.dims
            return out
        return tensor._wrap(self.array.to(_device(device)), self.dtype)

    def gpu(self):
        return self._to("cuda")

    def cpu(self):
        return self._to("cpu")

    def numpy(self):
        return self.array.detach().cpu().numpy()

    def elem(self):
        return int(np.prod(self.dims))

    @property
    def device(self) -> torch.device:
        return self.array.device

    @property
    def shape(self):
        return shape(*self.dims)

    def __repr__(self):
        return f"silt.tensor{self.dims}[{self.dtype}]"


def _arr(t):
    return t.array if isinstance(t, tensor) else torch.as_tensor(t)


def _like(t, arr):
    return tensor._wrap(arr, t.dtype) if isinstance(t, tensor) else arr


def set(t, value):
    """silt::set (graph.cu:552-553) — functional."""
    a = _arr(t)
    v = _arr(value) if isinstance(value, tensor) else value
    return _like(t, torch.broadcast_to(
        torch.as_tensor(v, dtype=a.dtype, device=a.device), a.shape).clone())


def multiply(t, value):
    return _like(t, _arr(t) * value)


def add(t, value):
    return _like(t, _arr(t) + value)


def clamp(t, lo, hi):
    return _like(t, torch.clamp(_arr(t), lo, hi))


def clone(t):
    return _like(t, _arr(t).clone())


def seed(t, seed_value: int, offset: int = 0) -> torch.Generator:
    """A fresh torch.Generator on the device of `t` (a silt tensor, an
    rng tensor or a torch tensor), deterministic in (seed, offset) like
    curand_init(seed, n, offset) (graph.cu:97-101) and seeded as
    `solve_uniform(seed=, offset=)` seeds its draws."""
    dev = t.device if isinstance(t, (tensor, torch.Generator)) else \
        _arr(t).device
    return seeded_generator(dev, seed_value, offset)
