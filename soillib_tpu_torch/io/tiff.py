"""`tiff` — float TIFF image interface (counterpart of
`soillib_tpu/io/tiff.py`; the reference's io/tiff.hpp).

    t = soil.tiff("height.tiff")      # load
    t.tensor                          # torch tensor (H, W), on the card
    t.tensor_on("cpu")                # ... or on a given device
    out = soil.tiff(array); out.write("out.tiff")

The image is held as a numpy array; torch tensors given to the
constructor (on any device) are copied to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from soillib_tpu_torch.core.device import _device
from soillib_tpu_torch.io import tiffcore


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class tiff:
    def __init__(self, source=None):
        self._array = None
        self._info = None
        self.filename = None
        if source is None:
            return
        if isinstance(source, (str, bytes)):
            self.read(source)
        else:
            self._array = _host(source)

    # -- I/O ---------------------------------------------------------------

    def peek(self, filename: str) -> bool:
        """Load metadata only."""
        self._info = tiffcore.peek(filename)
        self.filename = filename
        return True

    def read(self, filename: str) -> bool:
        arr, info = tiffcore.read(filename)
        self._array = arr
        self._info = info
        self.filename = filename
        return True

    def write(self, filename: str) -> bool:
        tiffcore.write(filename, np.asarray(self._array), self._extra_tags())
        return True

    def _extra_tags(self):
        return []

    # -- Properties ----------------------------------------------------------

    @property
    def width(self) -> int:
        if self._array is not None:
            return self._array.shape[1]
        return self._info.width if self._info else 0

    @property
    def height(self) -> int:
        if self._array is not None:
            return self._array.shape[0]
        return self._info.height if self._info else 0

    @property
    def bits(self) -> int:
        if self._array is not None:
            return np.asarray(self._array).dtype.itemsize * 8
        return self._info.bits if self._info else 0

    def tensor_on(self, device="cuda") -> torch.Tensor:
        """Image data as a torch tensor on `device` (the card unless the
        caller passes "cpu")."""
        return torch.as_tensor(np.array(self._array), device=_device(device))

    @property
    def tensor(self) -> torch.Tensor:
        """Image data as a torch tensor on the card (the reference's
        `.gpu()`); `tensor_on("cpu")` keeps it on the host."""
        return self.tensor_on("cuda")

    @property
    def buffer(self):
        return self.tensor

    @property
    def shape(self):
        if self._array is not None:
            return tuple(self._array.shape)
        return (self.height, self.width)

    def numpy(self):
        return np.asarray(self._array)
