"""What decides `correct`: each checked step of the program against the
plain reference run from the same input.

The cell's pipeline (`perfbench/pipelines/<name>.py`) says which gaps a
step has and how they group into the numbers compared, each against a
limit of its own (limits/<cell>.json); this module holds the arithmetic
they share. A gap is taken in float64; equal values (infinities included)
have no gap, and a NaN on one side only is a gap of NaN, which wins every
`worst` and fails every limit.
"""

from __future__ import annotations

import math

import torch


def gap(a, b) -> float:
    """The largest absolute difference of `a` and `b` (broadcast)."""
    a = a.double()
    b = b.double()
    a, b = torch.broadcast_tensors(a, b)
    d = torch.where(a == b, torch.zeros_like(a), torch.abs(a - b))
    if bool(torch.isnan(d).any()):
        return math.nan
    return float(d.max()) if d.numel() else 0.0


def scale(r) -> float:
    """The largest finite magnitude of `r`, or 0."""
    r = r.double()
    r = torch.where(torch.isfinite(r), torch.abs(r), torch.zeros_like(r))
    return float(r.max()) if r.numel() else 0.0


def worst_of(values) -> float:
    """The largest of `values`, or NaN where one is NaN."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def worst(readings: list) -> dict:
    """Each number's largest reading over checked steps (NaN wins)."""
    return {k: worst_of(r[k] for r in readings) for k in readings[0]}


def judge(numbers: dict, limits: dict) -> list:
    """The names of the numbers over (or not within) their limits, in the
    numbers' order. Every number needs a limit, and every limit a
    number."""
    if set(numbers) != set(limits):
        raise ValueError(f"the check's numbers {sorted(numbers)} and the "
                         f"cell's limits {sorted(limits)} differ")
    return [k for k in numbers if not numbers[k] <= limits[k]]
