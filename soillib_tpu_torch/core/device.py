"""Where the port's entry points put their data: on the card unless the
caller asks for the CPU, never on the CPU as a silent fallback."""

from __future__ import annotations

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
