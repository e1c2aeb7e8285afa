"""The coupled erosion step's pipeline: the configurations without a
"pipeline" key (configs/erosion-*.json).

The inputs are the fields of the program's `ErosionState`, made on the
device from the seed (the terrain of `perfbench.terrain`, the rest from the
configuration's `state`). The program is `soillib_tpu_torch.ErosionSim`
(its kernels built or loaded from `soillib_tpu_torch/_build/`, its step
captured as a CUDA graph), stepped by `step()`; a step's work is the
grid's W x H cells. After the window, with albedo tracked, the albedo
step: one more call from the program's state with its albedos drawn from
the seed (the configurations' albedos are uniform, which leaves the albedo
arithmetic unseen by the other steps). The reference is
`perfbench.reference.step.erode_step` in float32, the particle births
drawn from a generator of the program's seed advanced past the steps
before; the control is the same in bfloat16, the nearest precision below
the configuration's float32 (the step has no matrix product, so TF32
would change nothing).

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

A group's number is its worst field's; every field's gap is in the run's
`info.field_gaps`.
"""

from __future__ import annotations

import torch

from perfbench import check, spec, terrain
from perfbench.reference import rng, step as reference

GROUPS = {
    "surface": ("layers", "albedo_surface"),
    "fluvial": ("discharge", "mass", "momentum", "albedo_fluvial"),
    "debris": ("debris", "debris_momentum", "albedo_debris"),
    "passthrough": ("rainfall", "uplift", "albedo_bedrock"),
}
ALBEDOS = ("albedo_bedrock", "albedo_surface", "albedo_fluvial",
           "albedo_debris")


def make_fields(cfg: dict, trf: dict, seed: int, device) -> dict:
    """The cell's initial state, as a dict of the program's ErosionState
    fields, made by the benchmark on `device` from the seed."""
    W, H = cfg["grid"]
    h = terrain.height(cfg["terrain"], trf["terrain"], (W, H), seed, device)
    st = cfg["state"]

    def f(*c):
        return torch.zeros((*c, W, H), dtype=torch.float32, device=device)

    def scalar_field(v, default):
        if v is None:
            return torch.full((W, H), float(default), dtype=torch.float32,
                              device=device)
        return torch.full((1, 1), float(v), dtype=torch.float32,
                          device=device)

    def color(v):
        if v is None:
            return torch.ones((3, W, H), dtype=torch.float32, device=device)
        return torch.tensor(v, dtype=torch.float32,
                            device=device).reshape(3, 1, 1)

    surface = color(st["albedo_surface"])
    return {
        "layers": torch.stack([h, f()], dim=0),
        "rainfall": scalar_field(st["rainfall"], 1.0),
        "uplift": scalar_field(st["uplift"], 0.0),
        "discharge": f(), "mass": f(), "momentum": f(2), "debris": f(),
        "debris_momentum": f(2),
        "albedo_bedrock": color(st["albedo_bedrock"]),
        "albedo_surface": surface, "albedo_fluvial": surface,
        "albedo_debris": surface,
    }


def with_drawn_albedos(fields: dict, seed: int) -> dict:
    """`fields` with each albedo field replaced by one of the same shape
    drawn from the seed on its device, uniform in [0.2, 1) in every entry:
    the input of the albedo step that the check compares."""
    out = dict(fields)
    ref = fields["albedo_surface"]
    g = torch.Generator(device=ref.device).manual_seed(
        (int(seed) * 0x9E3779B97F4A7C15 + 5) % (1 << 63))
    for f in ALBEDOS:
        a = fields[f]
        out[f] = 0.2 + 0.8 * torch.rand(a.shape, generator=g,
                                        dtype=a.dtype, device=a.device)
    return out


def program_params(soil, p: dict):
    param = soil.ErosionParams()
    for k, v in p.items():
        setattr(param, k, v)
    return param


class Program:
    """The program's simulation: `step()` is the timed call, `state()` its
    fields by name, `load(fields)` replaces them."""

    def __init__(self, soil, sim, work: int, record: dict):
        self._soil = soil
        self._sim = sim
        self.work = work
        self.record = record

    def step(self):
        self._sim.step()

    def state(self) -> dict:
        return {f: getattr(self._sim.state, f) for f in reference.FIELDS}

    def load(self, fields: dict):
        self._sim.state = self._soil.ErosionState(**fields)


class Pipeline:
    """The erosion cells' part of a run (see `perfbench.spec`)."""

    NUMBERS = tuple(GROUPS)

    def __init__(self, cfg: dict, trf: dict, seed: int, device):
        import soillib_tpu_torch as soil

        self.soil = soil
        self.cfg, self.trf, self.seed = cfg, trf, int(seed)
        self.device = device
        self.p = spec.params(cfg, trf)
        self.scale = tuple(float(s) for s in cfg["scale"])
        self.sim_seed = terrain.sim_seed(seed)

    def inputs(self) -> dict:
        return make_fields(self.cfg, self.trf, self.seed, self.device)

    def setup(self, inputs: dict) -> Program:
        soil = self.soil
        W, H = self.cfg["grid"]
        sim = soil.ErosionSim((W, H), self.scale,
                              program_params(soil, self.p),
                              state=soil.ErosionState(**inputs),
                              seed=self.sim_seed, device=self.device)
        record = {"cells": W * H, "albedo": bool(self.p["trackAlbedo"])}
        return Program(soil, sim, W * H, record)

    def extra_inputs(self, state: dict) -> list:
        """The inputs of the steps checked after the window, from the
        program's state: the albedo step's, with albedo tracked."""
        if not self.p["trackAlbedo"]:
            return []
        return [with_drawn_albedos(state, self.seed)]

    def _generator(self, i: int):
        """The particle births' generator as it stands before step `i`."""
        if self.p["transportMethod"] != "particles":
            return None
        g = rng.generator(self.device, self.sim_seed)
        reference.skip_births(int(self.p["nSamples"]), g, self.device, i)
        return g

    def reference(self, inp: dict, i: int) -> dict:
        """The plain reference's step `i` from `inp`."""
        return reference.erode_step(inp, self.scale, self.p,
                                    self._generator(i))

    def control(self, inp: dict, i: int, dtype=torch.bfloat16) -> dict:
        """The reference's step `i` computed in `dtype`, returned in
        float32."""
        low = {k: v.to(dtype) for k, v in inp.items()}
        out = reference.erode_step(low, self.scale, self.p,
                                   self._generator(i))
        return {k: v.to(torch.float32) for k, v in out.items()}

    @staticmethod
    def gaps(inp: dict, prog: dict, ref: dict) -> dict:
        """Each field's gap for one checked step: `inp` its input fields,
        `prog` the program's output and `ref` the reference's (dicts of
        tensors on one device)."""
        out = {}
        d_prog = prog["layers"].double() - inp["layers"].double()
        d_ref = ref["layers"].double() - inp["layers"].double()
        out["layers"] = check.gap(d_prog, d_ref) / max(check.scale(d_ref),
                                                       1e-30)
        for g, names in GROUPS.items():
            for f in names:
                if f == "layers":
                    continue
                gap = check.gap(prog[f], ref[f])
                out[f] = gap if g == "passthrough" else (
                    gap / max(check.scale(ref[f]), 1e-30))
        return out

    @staticmethod
    def numbers(gaps: dict) -> dict:
        """The numbers of one checked step: each group's worst gap."""
        return {g: check.worst_of(gaps[f] for f in names)
                for g, names in GROUPS.items()}

    @staticmethod
    def counters() -> dict:
        """The program's counters, read around the profiled steps: the
        cohort rounds that ran and the particle kernel's live
        particle-rounds, each by kind."""
        from soillib_tpu_torch.ops import cohort, particles

        return {"cohort_rounds": dict(cohort.cohort_rounds),
                "particle_rounds": particles.particle_rounds()}
