"""Coupled erosion simulation driver (counterpart of
`soillib_tpu/models/simulation.py`).

A step is

    transport_fluvial -> transport_debris -> lrate blend -> mass_transfer
    -> mass_creep -> apply delta to layers

over an `ErosionState` dataclass of tensors. The legacy driver's `lrate`
learning-rate blend is applied to the transported fields:
new = (1 - lrate) * old + lrate * estimate.

Entry points (`ErosionState.zeros`, `ErosionSim`) put the state on the
card unless the caller passes `device="cpu"`; without a GPU they raise
rather than fall back to the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from soillib_tpu_torch.core.device import _device, seeded_generator
from soillib_tpu_torch.core.halo import NO_HALO
from soillib_tpu_torch.models.erosion import (
    mass_creep,
    mass_transfer,
    transport_debris,
    transport_fluvial,
)
from soillib_tpu_torch.models.params import ErosionParams


@dataclasses.dataclass(frozen=True)
class ErosionState:
    """Full prognostic state of the coupled erosion model: the reference's
    map_t (height/sediment/rainfall/uplift) + data_t (discharge/momentum/
    mass/debris/debris_momentum) + the albedo fields. Multichannel fields
    are channel-first; rainfall/uplift may be (1, 1) and the albedos
    (3, 1, 1) constant fields."""

    layers: torch.Tensor            # (2, W, H) bedrock, sediment
    rainfall: torch.Tensor          # (W, H) or (1, 1)
    uplift: torch.Tensor            # (W, H) or (1, 1)
    discharge: torch.Tensor         # (W, H) water height
    mass: torch.Tensor              # (W, H) suspended fluvial sediment
    momentum: torch.Tensor          # (2, W, H)
    debris: torch.Tensor            # (W, H)
    debris_momentum: torch.Tensor   # (2, W, H)
    albedo_bedrock: torch.Tensor    # (3, W, H) or (3, 1, 1)
    albedo_surface: torch.Tensor    # (3, W, H) or (3, 1, 1)
    albedo_fluvial: torch.Tensor    # (3, W, H) or (3, 1, 1)
    albedo_debris: torch.Tensor     # (3, W, H) or (3, 1, 1)

    @property
    def height(self):
        """Merged height (layer_merge, erosion.cu:733-757)."""
        return self.layers[0] + self.layers[1]

    @property
    def bedrock(self):
        return self.layers[0]

    @property
    def sediment(self):
        return self.layers[1]

    @property
    def device(self) -> torch.device:
        return self.layers.device

    def replace(self, **kw) -> "ErosionState":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def zeros(shape, height=None, rainfall=None, uplift=None, sediment=None,
              albedo_bedrock=None, albedo_surface=None, device="cuda"):
        """Fresh state on a (W, H) grid on `device`; `height` initializes
        bedrock. `rainfall`/`uplift` given as scalars (and the albedos as
        3-colors) are stored as broadcastable (1, 1)/(3, 1, 1) constant
        fields; arrays are kept as given."""
        dev = _device(device)
        W, H = int(shape[0]), int(shape[1])

        def f(*c):
            return torch.zeros((*c, W, H), dtype=torch.float32, device=dev)

        def asf(v):
            return torch.as_tensor(v, dtype=torch.float32, device=dev)

        def const2(v, default):
            if v is None:
                return default()
            a = asf(v)
            if a.numel() == 1 and a.dim() != 2:
                return a.reshape(1, 1)
            if a.dim() != 2:
                raise ValueError(
                    f"scalar field must be a scalar or a (W, H) array, got "
                    f"shape {tuple(a.shape)}"
                )
            return a

        def const3(v, default):
            if v is None:
                return default
            a = asf(v)
            return a.reshape(3, 1, 1) if tuple(a.shape) == (3,) else a

        bed = asf(height) if height is not None else f()
        sed = asf(sediment) if sediment is not None else f()
        white = torch.ones((3, W, H), dtype=torch.float32, device=dev)
        alb_bed = const3(albedo_bedrock, white)
        alb_surf = const3(albedo_surface, white)
        return ErosionState(
            layers=torch.stack([bed, sed], dim=0),
            rainfall=const2(rainfall, lambda: torch.ones(
                (W, H), dtype=torch.float32, device=dev)),
            uplift=const2(uplift, f),
            discharge=f(),
            mass=f(),
            momentum=f(2),
            debris=f(),
            debris_momentum=f(2),
            albedo_bedrock=alb_bed,
            albedo_surface=alb_surf,
            albedo_fluvial=alb_surf,
            albedo_debris=alb_surf,
        )


def _particle_key(key, state: ErosionState, param: ErosionParams):
    """`key` itself, or, where the particle transports need one and none
    was given, a generator on the state's device seeded from 0 (the JAX
    package's PRNGKey(0))."""
    if key is None and param.transportMethod == "particles":
        return seeded_generator(state.device)
    return key


def erode_step(
    state: ErosionState, scale, param: ErosionParams, key=None, halo=NO_HALO
) -> ErosionState:
    """One coupled erosion step. `key` is a torch.Generator on the state's
    device, or None (one seeded from 0). The field transports draw
    nothing from it; the particle transports draw their births from it,
    fluvial first, then debris. The JAX step splits its key into one for
    each solve; a torch.Generator advances as it draws, so drawing from
    the one generator in program order is the counterpart."""
    p = param
    lr = p.lrate
    key = _particle_key(key, state, p)

    dis, mas, mom, alb_f = transport_fluvial(
        state.layers, state.rainfall, state.discharge, state.mass,
        state.momentum, state.albedo_surface, scale, p, key=key, halo=halo,
    )
    # The JAX step puts an optimization_barrier here to keep XLA from
    # interleaving the two cohort solves; eager torch runs them in program
    # order, so there is nothing to sequence.
    deb, dmom, alb_d = transport_debris(
        state.layers, state.debris, state.debris_momentum,
        state.albedo_surface, scale, p, key=key, halo=halo,
    )

    def blend(old, new):
        return (1.0 - lr) * old + lr * new

    dis = blend(state.discharge, dis)
    mas = blend(state.mass, mas)
    mom = blend(state.momentum, mom)
    deb = blend(state.debris, deb)
    dmom = blend(state.debris_momentum, dmom)

    delta = torch.zeros_like(state.layers)
    delta, alb_s = mass_transfer(
        delta, state.layers, state.uplift, dis, mas, mom, deb, dmom,
        state.albedo_bedrock, alb_f, alb_d, state.albedo_surface, scale, p,
        halo=halo,
    )
    delta = mass_creep(delta, state.layers, scale, p, halo=halo)
    layers = state.layers + delta

    return state.replace(
        layers=layers,
        discharge=dis,
        mass=mas,
        momentum=mom,
        debris=deb,
        debris_momentum=dmom,
        albedo_surface=alb_s,
        albedo_fluvial=alb_f,
        albedo_debris=alb_d,
    )


def _canonicalize(state: ErosionState, param: ErosionParams) -> ErosionState:
    """Broadcast compact (3, 1, 1) albedo fields to full size when albedo
    IS tracked (they evolve, so outputs are full-size). With
    trackAlbedo=False they pass through untouched."""
    if not param.trackAlbedo:
        return state
    W, H = state.layers.shape[-2:]
    kw = {}
    for f in ("albedo_surface", "albedo_fluvial", "albedo_debris"):
        a = getattr(state, f)
        if tuple(a.shape[-2:]) == (1, 1):
            kw[f] = a.expand(3, W, H).contiguous()
    return state.replace(**kw) if kw else state


def make_erode_fn(param: ErosionParams, scale, steps: int = 1):
    """Erosion driver: fn(state, key=None) -> state after `steps` coupled
    steps. The parameters and scale are captured as they are now (the JAX
    package compiles them in); later edits of `param` do not reach fn.
    `key` (a torch.Generator on the state's device, or None: one seeded
    from 0) serves every step in turn, as the JAX package's
    make_erode_fn splits its key once a step."""
    param = ErosionParams.from_frozen(param.freeze())
    scale = tuple(float(s) for s in scale)
    steps = int(steps)

    def fn(state, key=None):
        state = _canonicalize(state, param)
        key = _particle_key(key, state, param)
        for _ in range(steps):
            state = erode_step(state, scale, param, key)
        return state

    return fn


def erode(state: ErosionState, scale, param: ErosionParams, steps: int = 1,
          key=None):
    """Reference-style convenience driver (`soil.erode(...)`,
    erosion_gpu.py:105): runs `steps` coupled steps."""
    return make_erode_fn(param, scale, steps)(state, key)


class ErosionSim:
    """Stateful convenience wrapper (holds state + scale + params):

        sim = ErosionSim(shape=(256, 256), scale=(0.078, 0.078, 4.0), param=p)
        for _ in range(512):
            sim.step()

    The state lives on `device` (the card unless "cpu" is asked for)."""

    def __init__(self, shape, scale, param: ErosionParams = None,
                 state: ErosionState = None, seed: int = 0, device="cuda"):
        self.scale = tuple(float(s) for s in scale)
        self.param = param or ErosionParams()
        self.state = (state if state is not None
                      else ErosionState.zeros(shape, device=device))
        # The particle transports draw from it (on the state's device);
        # it advances from step to step as the JAX package's ErosionSim
        # splits its key.
        self.key = seeded_generator(self.state.device, int(seed))

    def step(self, n: int = 1):
        self.state = make_erode_fn(self.param, self.scale, steps=n)(
            self.state, self.key)
        return self.state
