"""Carry states and parameters between numpy, this package and the JAX
package's field names, so one state can run through both packages."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from soillib_tpu_torch.core.device import _device
from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.models.simulation import FIELDS as STATE_FIELDS
from soillib_tpu_torch.models.simulation import ErosionState
from soillib_tpu_torch.ops.cohort import CohortClosure


def state_from_numpy(fields: dict, device) -> ErosionState:
    """ErosionState from numpy arrays keyed by the `ErosionState` field
    names (the JAX package's names); every field is required."""
    missing = [k for k in STATE_FIELDS if k not in fields]
    extra = [k for k in fields if k not in STATE_FIELDS]
    if missing or extra:
        raise ValueError(f"state fields: missing {missing}, unknown {extra}")
    dev = _device(device)
    return ErosionState(**{
        k: torch.as_tensor(np.asarray(fields[k], np.float32), device=dev)
        for k in STATE_FIELDS
    })


def state_to_numpy(state: ErosionState) -> dict:
    """{field name: float32 numpy array} of a state."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in STATE_FIELDS}


def _closure(c):
    """A closure value of either package as this package's CohortClosure
    (None and strings such as closureDebris="same" pass through)."""
    if c is None or isinstance(c, (str, CohortClosure)):
        return c
    if dataclasses.is_dataclass(c):
        names = {f.name for f in dataclasses.fields(CohortClosure)}
        return CohortClosure(**{f.name: getattr(c, f.name)
                                for f in dataclasses.fields(c)
                                if f.name in names})
    raise TypeError(f"not a cohort closure: {c!r}")


def params_from_frozen(frozen) -> ErosionParams:
    """ErosionParams from a `freeze()` snapshot of either package; the
    closures become this package's CohortClosure."""
    return ErosionParams.from_frozen(
        (name, _closure(v) if name in ("closure", "closureDebris") else v)
        for name, v in frozen
    )
