"""Coupled erosion simulation driver (counterpart of
`soillib_tpu/models/simulation.py`).

A step is

    transport_fluvial -> transport_debris -> lrate blend -> mass_transfer
    -> mass_creep -> apply delta to layers

over an `ErosionState` dataclass of tensors. The legacy driver's `lrate`
learning-rate blend is applied to the transported fields:
new = (1 - lrate) * old + lrate * estimate.

`erode_step` is the eager step. `make_erode_fn`, `erode` and `ErosionSim`
run the compiled one, the counterpart of the JAX package's
`_compiled_step`: one step captured as a CUDA graph on the card (a
`core.graphs.CapturedStep`, cached on the parameters, the scale, `donate`
and the state's shapes), replayed once a step.

Entry points (`ErosionState.zeros`, `ErosionSim`) put the state on the
card unless the caller passes `device="cpu"`; without a GPU they raise
rather than fall back to the CPU.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from soillib_tpu_torch.core.device import _device, seeded_generator
from soillib_tpu_torch.core.graphs import CapturedStep
from soillib_tpu_torch.core.halo import NO_HALO
from soillib_tpu_torch.core.trace import mark, span
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
    the one generator in program order is the counterpart.

    Under a CUDA-graph capture the step marks the ends of its phases
    (`core/trace.py` `mark`: after each solve and after the update);
    eager, it launches no mark."""
    p = param
    lr = p.lrate
    key = _particle_key(key, state, p)

    dis, mas, mom, alb_f = transport_fluvial(
        state.layers, state.rainfall, state.discharge, state.mass,
        state.momentum, state.albedo_surface, scale, p, key=key, halo=halo,
    )
    mark("fluvial_end")
    # The JAX step puts an optimization_barrier here to keep XLA from
    # interleaving the two cohort solves; eager torch runs them in program
    # order, so there is nothing to sequence.
    deb, dmom, alb_d = transport_debris(
        state.layers, state.debris, state.debris_momentum,
        state.albedo_surface, scale, p, key=key, halo=halo,
    )
    mark("debris_end")

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
    mark("update_end")

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


FIELDS = tuple(f.name for f in dataclasses.fields(ErosionState))
_TRACKED_ALBEDO = ("albedo_surface", "albedo_fluvial", "albedo_debris")

# The compiled steps, most recently used last. Unlike an XLA executable a
# captured graph holds memory: its buffers (one state) and its temporaries,
# from one pool a device that all of them share (`_pools`: they replay one
# at a time). So only COMPILED_STEPS of them stay alive; an evicted one
# frees its buffers (a donated state that a caller still holds stays
# valid) and its share of the pool.
COMPILED_STEPS = 4
_compiled = collections.OrderedDict()
_pools = {}


def _signature(state: ErosionState, param: ErosionParams) -> tuple:
    """The device and every field's shape as the step sees it, after
    `_canonicalize`: compact (3, 1, 1) albedo fields count as full size
    when albedo is tracked (the step broadcasts them), so a compact state
    and the full-size states after it share one compiled step; rainfall
    and uplift may be (1, 1)."""
    W, H = state.layers.shape[-2:]
    shapes = []
    for f in FIELDS:
        shape = tuple(getattr(state, f).shape)
        if (param.trackAlbedo and f in _TRACKED_ALBEDO
                and shape[-2:] == (1, 1)):
            shape = (3, W, H)
        shapes.append(shape)
    return str(state.device), tuple(shapes)


def _compiled_step(param, frozen, scale, donate, state) -> CapturedStep:
    """The compiled step of (params, scale, donate, the state's
    signature), made on first use from `state`: the port's
    `_compiled_step` (JAX: a jitted fori_loop cached on (params, scale,
    steps, donate)). `param` is `frozen` thawed, which the step keeps. One
    graph is one step, so `steps` is not in the key: a call of n steps
    replays it n times."""
    key = (frozen, scale, bool(donate), _signature(state, param))
    step = _compiled.get(key)
    if step is not None:
        _compiled.move_to_end(key)
        return step

    def one_step(fields, generator):
        out = erode_step(_canonicalize(ErosionState(**fields), param), scale,
                         param, generator)
        return {f: getattr(out, f) for f in FIELDS}

    canon = _canonicalize(state, param)
    pool = None
    if state.device.type == "cuda":
        pool = _pools.get(state.device)
        if pool is None:
            pool = _pools[state.device] = torch.cuda.graph_pool_handle()
    try:
        step = CapturedStep(one_step, {f: getattr(canon, f) for f in FIELDS},
                            draws=param.transportMethod == "particles",
                            pool=pool)
    except BaseException:
        # A failed capture leaves its pool recording: later captures on
        # the device take a new one.
        _pools.pop(state.device, None)
        raise
    _compiled[key] = step
    while len(_compiled) > COMPILED_STEPS:
        _compiled.popitem(last=False)
    return step


def _needs_grad(state: ErosionState) -> bool:
    return torch.is_grad_enabled() and any(
        getattr(state, f).requires_grad for f in FIELDS)


def make_erode_fn(param: ErosionParams, scale, steps: int = 1,
                  donate: bool = False):
    """Compiled erosion driver: fn(state, key=None) -> state after `steps`
    coupled steps. The parameters and scale are captured as they are now
    (later edits of `param` do not reach fn). The step is compiled once
    per (params, scale, donate, the state's field shapes and device) and
    cached (`_compiled_step`): on the card, one `erode_step` captured as a
    CUDA graph and replayed `steps` times; on the CPU, the same buffers
    and copies around an eager step. `erode_step` itself is the eager
    step.

    `key` (a torch.Generator on the state's device, or None: one seeded
    from 0) serves every step in turn and advances as the eager steps
    would advance it; the field transports draw nothing.

    donate=False returns a fresh state; the input is only read.
    donate=True (the JAX package's buffer donation: one resident state,
    not two) returns the compiled step's own buffers, which the next call
    with the same parameters, scale and shapes overwrites, and takes them
    back as input without a copy; use it in step loops like ErosionSim.

    A state whose fields require grad, with grad enabled, runs the eager
    `erode_step` loop (the same kernels, with their autograd Functions):
    the reverse mode goes through the eager step, as the JAX package's
    goes through its jit."""
    frozen = param.freeze()
    param = ErosionParams.from_frozen(frozen)
    scale = tuple(float(s) for s in scale)
    steps = int(steps)
    draws = param.transportMethod == "particles"

    def fn(state, key=None):
        key = _particle_key(key, state, param)
        if _needs_grad(state):
            state = _canonicalize(state, param)
            for _ in range(steps):
                state = erode_step(state, scale, param, key)
            return state
        step = _compiled_step(param, frozen, scale, donate, state)
        out = step({f: getattr(state, f) for f in FIELDS}, steps,
                   key if draws else None, donate)
        return ErosionState(**out)

    return fn


def erode(state: ErosionState, scale, param: ErosionParams, steps: int = 1,
          key=None):
    """Reference-style convenience driver (`soil.erode(...)`,
    erosion_gpu.py:105): runs `steps` coupled steps, compiled and cached
    (`make_erode_fn`)."""
    return make_erode_fn(param, scale, steps)(state, key)


class ErosionSim:
    """Stateful convenience wrapper (holds state + scale + params):

        sim = ErosionSim(shape=(256, 256), scale=(0.078, 0.078, 4.0), param=p)
        for _ in range(512):
            sim.step()

    The state lives on `device` (the card unless "cpu" is asked for).
    With donate=True the state is the compiled step's own buffers, and a
    step copies no state at all (`make_erode_fn`)."""

    def __init__(self, shape, scale, param: ErosionParams = None,
                 state: ErosionState = None, seed: int = 0,
                 donate: bool = False, device="cuda"):
        self.scale = tuple(float(s) for s in scale)
        self.param = param or ErosionParams()
        self.state = (state if state is not None
                      else ErosionState.zeros(shape, device=device))
        # The particle transports draw from it (on the state's device);
        # it advances from step to step as the JAX package's ErosionSim
        # splits its key.
        self.key = seeded_generator(self.state.device, int(seed))
        self.donate = donate

    def step(self, n: int = 1):
        with span("soil.step"):
            self.state = make_erode_fn(self.param, self.scale, steps=n,
                                       donate=self.donate)(self.state,
                                                           self.key)
        return self.state
