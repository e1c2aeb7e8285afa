"""What decides `correct`: each checked step of the program against the
plain reference run from the same input.

Each field's gap is taken in float64: for the two height layers the
largest gap between the program's and the reference's change in the
step, over the reference's largest change; for every other evolving
field the largest gap over the reference field's largest magnitude.
Equal values (infinities included) have no gap; a NaN on one side only
is a gap of NaN, which fails every limit. The numbers compared, each
against a limit of its own (limits/<cell>.json), group the fields by the
stage of the step that writes them:

* `surface`: the layers and the surface albedo (mass transfer, creep);
* `fluvial`: discharge, suspended mass, momentum and the fluvial albedo
  (the fluvial transport and the blend);
* `debris`: debris, its momentum and the debris albedo (the debris
  transport and the blend);
* `passthrough`: the largest absolute gap in the fields the step passes
  through unchanged (rainfall, uplift, bedrock albedo); exact, limit 0.

A group's number is its worst field's; every field's gap is in `fields`.
"""

from __future__ import annotations

import math

import torch

GROUPS = {
    "surface": ("layers", "albedo_surface"),
    "fluvial": ("discharge", "mass", "momentum", "albedo_fluvial"),
    "debris": ("debris", "debris_momentum", "albedo_debris"),
    "passthrough": ("rainfall", "uplift", "albedo_bedrock"),
}
NUMBERS = tuple(GROUPS)


def _gap(a, b) -> float:
    a = a.double()
    b = b.double()
    a, b = torch.broadcast_tensors(a, b)
    d = torch.where(a == b, torch.zeros_like(a), torch.abs(a - b))
    if bool(torch.isnan(d).any()):
        return math.nan
    return float(d.max()) if d.numel() else 0.0


def _scale(r) -> float:
    r = r.double()
    r = torch.where(torch.isfinite(r), torch.abs(r), torch.zeros_like(r))
    return float(r.max()) if r.numel() else 0.0


def fields(inp: dict, prog: dict, ref: dict) -> dict:
    """Each field's gap for one checked step: `inp` its input fields,
    `prog` the program's output and `ref` the reference's (dicts of
    tensors on one device)."""
    out = {}
    d_prog = prog["layers"].double() - inp["layers"].double()
    d_ref = ref["layers"].double() - inp["layers"].double()
    out["layers"] = _gap(d_prog, d_ref) / max(_scale(d_ref), 1e-30)
    for g, names in GROUPS.items():
        for f in names:
            if f == "layers":
                continue
            gap = _gap(prog[f], ref[f])
            out[f] = gap if g == "passthrough" else (
                gap / max(_scale(ref[f]), 1e-30))
    return out


def _worst(values):
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def compare(inp: dict, prog: dict, ref: dict) -> dict:
    """The numbers of one checked step (see the module docstring)."""
    gaps = fields(inp, prog, ref)
    return {g: _worst(gaps[f] for f in names)
            for g, names in GROUPS.items()}


def worst(readings: list) -> dict:
    """Each number's largest reading over checked steps (NaN wins)."""
    return {k: _worst(r[k] for r in readings) for k in readings[0]}


def judge(numbers: dict, limits: dict) -> list:
    """The names of the numbers over (or not within) their limits."""
    return [k for k in NUMBERS if not numbers[k] <= limits[k]]
