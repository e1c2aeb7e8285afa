"""Unified erosion model in PyTorch (counterpart of
`soillib_tpu/models/erosion.py`: `transportMethod="field"`, the default,
`"field-static"` and `"particles"`).

The terrain is a two-layer state `layers` = (bedrock, sediment) heights,
stored dimensionless and dimensionalized by scale.z (erosion.hpp:60;
erosion.cu:441-451). Every multichannel field is channel-first: layers
(2, W, H), momentum (2, W, H), albedo (3, W, H), gradients (2, W, H).

Per step:
  1. `transport_fluvial`  — steady-state water/sediment-mass/momentum fields
  2. `transport_debris`   — steady-state debris-flow mass/momentum fields
  3. `mass_transfer`      — Eulerian height-field delta
  4. `mass_creep`         — thermal creep
  5. apply delta; `layer_merge` for export

Both transports are age-structured cohort solves (ops/cohort.py); with
"field-static" the fluvial one is the static-attenuation linear sweep
(ops/sweep.py) instead. On CUDA tensors each round of either is one launch
of a hand-written kernel, on CPU tensors a plain torch round. With
"particles" both transports run the reference's Monte-Carlo estimator
itself (`_fluvial_particles`, `_debris_particles`): births, sources and
normalisation in plain torch, and the trajectory loop (`_particle_rounds`)
one launch of a hand-written kernel per estimator on CUDA tensors
(csrc/particle_rounds.cu), plain torch gathers, elementwise rounds and
`index_add_` on CPU tensors (as the JAX package's are XLA gathers and
scatter-adds). Everything else here is elementwise and radius-1 stencil
work in plain torch.

Numerical quirks of the reference reproduced on purpose (do not "fix"):
ks/64, kd*1.33, fD/8 (erosion.cu:68-70, 478-480); norm = scale.y
(erosion.cu:165-166, 372-373); the +-0.25*L transfer clamps
(erosion.cu:527-528); sediment-before-bedrock erosion, uplift to bedrock
only (erosion.cu:530-547); creep symmetry (erosion.cu:633-710).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from soillib_tpu_torch.core.device import device_constant, seeded_generator
from soillib_tpu_torch.core.halo import NO_HALO
from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.ops import particles, transport
from soillib_tpu_torch.ops.cohort import ENV_CLOSURE, NSTATE, _check_closure
from soillib_tpu_torch.ops.noise import _div, mul_u32
from soillib_tpu_torch.ops.stencil import _shift
from soillib_tpu_torch.ops.transport import (
    _f32,
    _stepsize_xy,
    expected_exp_step,
    stepsize_center,
)

_EPS = 1e-12

# The smallest normal float32. The JAX package runs with subnormal floats
# flushed to zero (XLA does so on the CPU and the TPU), so a result that is
# subnormal reads as 0 in its decisions; torch keeps subnormals on the CPU
# and the card. The port's decisions on such values (is there albedo mass,
# is a cell bare, is any carried mass left) compare against this instead of
# 0 and so decide as the JAX package does on every device. (A sum of
# squares is > 0 after flushing iff one square is a normal float.)
_TINY = torch.finfo(torch.float32).tiny

# Exp-rate coefficients fed to `expected_exp_step` are clipped to this
# magnitude (see the JAX package: at +-1e4 every attenuation is already ~0
# and every growth already saturates the 1e30 carried-total clamp).
_RATE_CLIP = 1e4


def _sdiv(a: float, t):
    """a / t for a Python scalar a, as one float32 division. (`a / t`
    on a tensor computes t.reciprocal() * a, which rounds twice.)"""
    return torch.full((), a, dtype=t.dtype, device=t.device) / t


def _birth_density(W, H, halo=NO_HALO, device="cpu"):
    """Relative particle-birth density of the reference MC sampler:
    erosion.cu births particles uniformly over the INSET (W-1)x(H-1) area
    (erosion.cu:53-58), so interior cells receive W*H/((W-1)*(H-1)) times
    the nominal density, edge cells half of that, corners a quarter."""
    x0, y0, Wg, Hg = halo.global_offsets((W, H))
    gx = x0 + torch.arange(W, device=device)
    gy = y0 + torch.arange(H, device=device)
    fx = torch.where((gx == 0) | (gx == Wg - 1), 0.5, 1.0).float() * (
        Wg / max(Wg - 1.0, 1.0))
    fy = torch.where((gy == 0) | (gy == Hg - 1), 0.5, 1.0).float() * (
        Hg / max(Hg - 1.0, 1.0))
    return fx[:, None] * fy[None, :]


def merged_height(layers):
    """height = bedrock + sediment (dimensionless); layers is (2, W, H)."""
    return layers[0] + layers[1]


def layer_merge(layers):
    """Ref: erosion.cu:733-757."""
    return merged_height(layers)


def godunov_gradient(height, scale, exit_slope, halo=NO_HALO):
    """Godunov-style steepest one-sided gradient with exit-slope BC
    (__glocal, erosion_map.cu:107-159): per axis the backward slope is
    kept only if the neighbor is lower, the forward one only if it is
    higher, out-of-bounds neighbors contribute the signed exit slope, and
    the steeper magnitude wins (backward on ties). Returns (2, W, H)."""
    h = halo.pad(height, math.nan)
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    hn0 = _shift(h, -1, 0, math.nan)
    hp0 = _shift(h, +1, 0, math.nan)
    h0n = _shift(h, 0, -1, math.nan)
    h0p = _shift(h, 0, +1, math.nan)

    def one_axis(hn, hp, s):
        miss_n = torch.isnan(hn)
        miss_p = torch.isnan(hp)
        gn = (h - torch.where(miss_n, h, hn)) * sz / s
        gn = torch.where(miss_n, exit_slope, torch.clamp(gn, min=0.0))
        gp = (torch.where(miss_p, h, hp) - h) * sz / s
        gp = torch.where(miss_p, -exit_slope, torch.clamp(gp, max=0.0))
        return torch.where(torch.abs(gp) > torch.abs(gn), gp, gn)

    gx = one_axis(hn0, hp0, sx)
    gy = one_axis(h0n, h0p, sy)
    return torch.stack([halo.crop(gx), halo.crop(gy)], dim=0)


def _len2(x, y):
    """2-norm of component fields, double-where'd at 0 (for autograd)."""
    sq = x * x + y * y
    zero = sq == 0.0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))


def _safe_pow(x, alpha):
    """x**alpha for x >= 0 with a finite gradient at x == 0."""
    zero = x == 0.0
    return torch.where(zero, 0.0, torch.pow(torch.where(zero, 1.0, x), alpha))


def _masked_exp(alive, arg):
    """where(alive, exp(arg), 0) with the argument itself masked."""
    return torch.where(alive, torch.exp(torch.where(alive, arg, 0.0)), 0.0)


# ---------------------------------------------------------------------------
# Age-structured cohort sweep
# ---------------------------------------------------------------------------


def _cohort_state(w0, speed0, carried0):
    """Initial cohort state channels (ops/cohort.py layout): weight,
    weighted mean velocity, weighted second velocity moments and cross
    moment (newborns are velocity-deterministic), sub-cell offset moments
    of a uniform birth position (mean 1/2, E[f^2] = 1/3), carried totals."""
    return (w0, w0 * speed0[0], w0 * speed0[1],
            w0 * speed0[0] * speed0[0],
            w0 * speed0[1] * speed0[1],
            w0 * speed0[0] * speed0[1],
            w0 * 0.5, w0 * 0.5,
            w0 * (1.0 / 3.0), w0 * (1.0 / 3.0)) + tuple(carried0)


def _color_masks(M, rule, speed, shape, halo=NO_HALO):
    """Disjoint {0, 1} float birth-partition masks for the colored
    quality mode (CohortClosure.colors); the masks sum to 1.

    "dir": birth-velocity angle sectors, rotated half a bin. "hash": a
    Knuth mix of the global cell index. "peak": a hash of the local peak
    each birth cell drains from, found by following the quantized
    steepest-ascent direction (-speed) with ceil(log2(W*H)) rounds of
    pointer doubling (r = r[r]). The uint32 hash arithmetic runs in int64
    (`mul_u32`)."""
    W, H = int(shape[0]), int(shape[1])
    dev = speed.device
    if rule == "dir":
        theta = torch.atan2(speed[1], speed[0])  # (-pi, pi]
        sect = torch.floor((theta + math.pi) * (M / (2.0 * math.pi)) + 0.5)
        idx = sect.to(torch.int64) % M
    elif rule == "peak":
        if halo is not NO_HALO:
            raise NotImplementedError(
                "color_rule='peak' needs a global pointer chase; use "
                "'hash' or 'dir' under sharding"
            )
        theta = torch.atan2(-speed[1], -speed[0])
        sect = torch.floor(theta * (4.0 / math.pi) + 0.5).to(torch.int64) % 8
        d8x = device_constant((1, 1, 0, -1, -1, -1, 0, 1), torch.int64, dev)
        d8y = device_constant((0, 1, 1, 1, 0, -1, -1, -1), torch.int64, dev)
        dx = d8x[sect]
        dy = d8y[sect]
        xi = torch.arange(W, device=dev)[:, None]
        yi = torch.arange(H, device=dev)[None, :]
        self_idx = xi * H + yi
        up = (torch.clamp(xi + dx, 0, W - 1) * H
              + torch.clamp(yi + dy, 0, H - 1))
        still = _len2(speed[0], speed[1]) <= _EPS
        r = torch.where(still, self_idx, up).reshape(-1)
        for _ in range(max(1, math.ceil(math.log2(float(W) * H)))):
            r = r[r]
        h = mul_u32(r, 2654435761)
        h = mul_u32(h ^ (h >> 16), 2246822519)
        idx = ((h ^ (h >> 13)) % M).reshape(W, H)
    elif rule == "hash":
        x0, y0, _, Hg = halo.global_offsets((W, H))
        gx = x0 + torch.arange(W, dtype=torch.int64, device=dev)[:, None]
        gy = y0 + torch.arange(H, dtype=torch.int64, device=dev)[None, :]
        h = mul_u32((gx * Hg + gy) & 0xFFFFFFFF, 2654435761)
        h = mul_u32(h ^ (h >> 16), 2246822519)
        idx = ((h ^ (h >> 13)) % M).expand(W, H)
    else:
        raise ValueError(f"unknown color_rule: {rule!r}")
    return [torch.where(idx == m, 1.0, 0.0) for m in range(M)]


def _node_masks(nnodes, speed, node_rule="face"):
    """Birth-node assignment for the N-node mixture (CohortClosure.nodes):
    face rule, a newborn cohort joins the node of the face its velocity
    points toward ([+x, -x, +y, -y]; nodes=2 pools the signs per axis);
    sign and cluster rules, its velocity sign quadrant ([++, +-, -+, --];
    cluster nodes seed from the quadrant prototypes); speed rule
    ([fast, slow]), the fast node (the slow one fills from slow
    arrivals). Any other rule is the face rule, as in the JAX package."""
    if node_rule == "speed":
        if nnodes != 2:
            raise ValueError("node_rule='speed' requires nodes=2")
        one = torch.ones_like(speed[0])
        return [one, torch.zeros_like(one)]
    if node_rule in ("sign", "cluster"):
        if nnodes != 4:
            raise ValueError(f"node_rule={node_rule!r} requires nodes=4")
        xpos = speed[0] >= 0.0
        ypos = speed[1] >= 0.0
        return [torch.where(xpos & ypos, 1.0, 0.0),
                torch.where(xpos & ~ypos, 1.0, 0.0),
                torch.where(~xpos & ypos, 1.0, 0.0),
                torch.where(~xpos & ~ypos, 1.0, 0.0)]
    isx = torch.abs(speed[0]) >= torch.abs(speed[1])
    if nnodes == 2:
        mx = torch.where(isx, 1.0, 0.0)
        return [mx, 1.0 - mx]
    if nnodes == 4:
        xpos = speed[0] >= 0.0
        ypos = speed[1] >= 0.0
        return [torch.where(isx & xpos, 1.0, 0.0),
                torch.where(isx & ~xpos, 1.0, 0.0),
                torch.where(~isx & ypos, 1.0, 0.0),
                torch.where(~isx & ~ypos, 1.0, 0.0)]
    raise ValueError(f"nodes must be 1, 2 or 4, got {nnodes}")


def _build_cohort_state(w0, speed, carried0, closure):
    """Initial cohort state channels, node-split when the closure asks
    for the N-node mixture (every channel carries a w0 factor, so node
    masking is a per-channel multiply)."""
    nnodes = int(getattr(closure, "nodes", 1) or 1) if closure else 1
    if nnodes <= 1:
        return _cohort_state(w0, speed, carried0)
    chans = ()
    for mk in _node_masks(nnodes, speed, closure.node_rule):
        chans += _cohort_state(w0 * mk, speed, [c * mk for c in carried0])
    return chans


def color_chunk(M, per, shape, device) -> int:
    """Color groups per cohort solve. On the card: the largest divisor c
    of M whose state buffers fit in half of the device memory the CUDA
    driver reports free (`torch.cuda.mem_get_info`). A solve holds three of
    them, the chunk's initial state and the two ping-pong states of the
    rounds, each c x `per` channels x W x H x 4 B: at 4096^2 one color of
    nodes=4, C=7 is 68 channels, 4.6 GB a buffer. Memory cached by
    torch's allocator is not counted: smaller tensors split its
    segments, so it may hold no whole buffer; a later solve, with the
    first one's buffers cached, takes smaller chunks and reuses them.
    Elsewhere every color goes into one solve, as the JAX package does
    off the TPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return M
    free, _ = torch.cuda.mem_get_info(device)
    W, H = int(shape[0]), int(shape[1])
    for c in range(M, 1, -1):
        if M % c == 0 and 3 * c * per * W * H * 4 <= free / 2:
            return c
    return 1


def _debris_closure(p):
    """Effective debris-transport closure (ErosionParams.closureDebris):
    the default strips the quality knobs (nodes/colors) from `closure`."""
    cd = getattr(p, "closureDebris", None)
    if cd == "same":
        return p.closure
    if cd is not None:
        return cd
    if p.closure is None:
        return None
    return dataclasses.replace(p.closure, nodes=1, colors=1)


def _run_cohort_colored(halo, w0, speed, carried0, aux, rules, iters,
                        Llen, closure, tol=0.0):
    """Cohort solve -> (C, W, H) deposits, optionally split into
    `closure.colors` disjoint birth sub-populations whose deposits sum
    (transport is linear in sources). The color sub-states go through
    the solve `color_chunk` at a time, each chunk one state of stacked
    color groups; the chunks' deposits add in order."""
    cl = _check_closure(closure or ENV_CLOSURE)
    M = int(cl.colors or 1)
    if M <= 1:
        st0 = _build_cohort_state(w0, speed, carried0, cl)
        return halo.run_cohort(st0, aux, rules, iters, Llen, closure,
                               tol=tol)
    masks = _color_masks(M, cl.color_rule, speed, w0.shape, halo)
    nnodes = int(cl.nodes or 1)
    per = nnodes * (NSTATE + len(carried0))
    cb = color_chunk(M, per, w0.shape, w0.device)
    G = None
    for j0 in range(0, M, cb):
        chunk = masks[j0:j0 + cb]
        # The chunk's state is filled color by color, so at most one
        # color's channels exist beside it.
        st = torch.empty((len(chunk) * per,) + tuple(w0.shape),
                         dtype=torch.float32, device=w0.device)
        for m, mk in enumerate(chunk):
            chans = _build_cohort_state(w0 * mk, speed,
                                        [c * mk for c in carried0], cl)
            for k, ch in enumerate(chans):
                st[m * per + k] = ch
            del chans
        g = halo.run_cohort(st, aux, rules, iters, Llen,
                            dataclasses.replace(cl, colors=len(chunk)),
                            tol=tol)
        del st
        G = g if G is None else G + g
    return G


# ---------------------------------------------------------------------------
# Fluvial transport
# ---------------------------------------------------------------------------


def _fluvial_terms(
    layers, rainfall, discharge, momentum, albedo_surface, scale, p,
    halo=NO_HALO,
):
    """Shared source/attenuation terms of the fluvial transport model
    (erosion.cu:62-96)."""
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    A = sx * sy
    Llen = math.sqrt(sx * sx + sy * sy)
    dev = layers.device

    rho_w = p.densityWater
    nu = p.viscosityWater
    tau = p.bedShearWater
    g = p.gravity
    ks = p.suspensionRateFluvial / 64.0   # erosion.cu:68
    kd = p.depositionRateFluvial * 1.33   # erosion.cu:69
    fD = p.frictionFactor / 8.0           # erosion.cu:70
    alpha = p.fluvialExponent
    R = p.rainfall
    force = device_constant(tuple(p.force), torch.float32, dev)

    grad = godunov_gradient(merged_height(layers), scale, p.exitSlope, halo)
    vel = momentum

    # Trajectory-initial speed (erosion.cu:75-79): normalized by sqrt(|L*v|).
    speed = -(g * grad) + nu * vel + force[:, None, None]
    speed = speed / torch.sqrt(
        torch.clamp(_len2(sx * speed[0], sy * speed[1]), min=_EPS)
    )[None]

    # Source terms (erosion.cu:83-91).
    v = _len2(vel[0], vel[1])
    shear = 0.125 * fD * rho_w * v * v
    power = _safe_pow(torch.clamp(shear * _len2(grad[0], grad[1]), min=0.0),
                      alpha)
    E_m = A * ks * power
    # rainfall may be a (1, 1) constant field.
    E_w = torch.broadcast_to(A * R * rainfall, E_m.shape)
    E_v = A * (-(g * grad) + nu * vel)
    E_a = E_m[None] * albedo_surface if p.trackAlbedo else None

    return dict(
        A=A, Llen=Llen, grad=grad, speed=speed, force=force,
        E_w=E_w, E_m=E_m, E_v=E_v, E_a=E_a,
        kd=kd, fD=fD, nu=nu, tau=tau, g=g,
    )


def transport_fluvial(
    layers,
    rainfall,
    discharge,
    mass,
    momentum,
    albedo_surface,
    scale,
    param: ErosionParams,
    *,
    method: str = None,
    key=None,
    iterations: int = None,
    halo=NO_HALO,
):
    """Fluvial transport: steady-state water height (discharge), suspended
    sediment mass, momentum, and transported albedo.
    Ref: __transport_fluvial + __normalize_fluvial (erosion.cu:29-239).

    Args:
      layers: (2, W, H) terrain state (bedrock, sediment).
      rainfall: (W, H) water source field, or a (1, 1) constant.
      discharge: (W, H) previous water height.
      mass: (W, H) previous suspended mass (unused; kept for API parity).
      momentum: (2, W, H) previous momentum field.
      albedo_surface: (3, W, H) surface albedo (transport color source).
      scale: (sx, sy, sz).
      key: the particle method's torch.Generator, on the fields' device
        (None: one seeded from 0 there, as the JAX package takes
        PRNGKey(0)); unused by the field methods.
    Returns:
      (discharge', mass', momentum', albedo_transport').
    """
    p = param
    method = method or p.transportMethod
    if method not in ("field", "field-static", "particles"):
        raise ValueError(f"unknown transport method: {method!r}")
    if method == "particles":
        _check_single_device(halo)
    t = _fluvial_terms(
        layers, rainfall, discharge, momentum, albedo_surface, scale, p, halo
    )
    # Default rounds = maxage - 2: the MC trajectory loop runs maxage-1
    # iterations and its first iteration never deposits.
    iters = iterations or (p.transportIterations or max(p.maxage - 2, 1))
    if method == "field":
        Gcf = _fluvial_cohort(t, rainfall, discharge, p, iters, halo)
    elif method == "field-static":
        # Static-attenuation linear solve: fast, but blind to the
        # trajectory velocity evolution (the JAX package's
        # benchmarks/parity.py: noise-terrain discharge corr 0.19 vs 0.99).
        Gcf = _fluvial_field(t, discharge, p, iters, halo)
    else:
        if key is None:
            key = seeded_generator(discharge.device)
        Gcf = _fluvial_particles(
            layers, rainfall, discharge, momentum, albedo_surface, scale, p,
            key,
        ).reshape(7, *discharge.shape)

    G_w, G_m = Gcf[0], Gcf[1]
    G_vx, G_vy = Gcf[2], Gcf[3]
    G_a = Gcf[4:7] if Gcf.shape[0] > 4 else None

    # Normalization (erosion.cu:143-187). Fixed v=(1,0) -> norm = scale.y.
    norm = float(scale[1])
    A = t["A"]
    grad = t["grad"]
    force = t["force"]
    sv_x = -p.gravity * grad[0] + force[0]
    sv_y = -p.gravity * grad[1] + force[1]
    discharge_out = (A * p.rainfall * rainfall + G_w) / norm
    mass_out = G_m / norm
    momentum_out = torch.stack(
        [(A * sv_x + G_vx) / norm, (A * sv_y + G_vy) / norm], dim=0
    )

    if G_a is None:
        albedo_out = albedo_surface  # untracked: identity pass-through
    else:
        has_mass = (G_m >= _TINY) & torch.any(G_a * G_a >= _TINY, dim=0)
        albedo_out = torch.where(
            has_mass[None], G_a / torch.clamp(G_m, min=_EPS)[None],
            albedo_surface,
        )
    return discharge_out, mass_out, momentum_out, albedo_out


class FluvialRules:
    """The fluvial cohort physics callback (models/erosion.py
    `make_fluvial_rules` in the JAX package). Per-cell inputs ride in
    `aux`; the static scalars are attributes, which the CUDA kernel
    receives through `kernel_scalars()`.

    Returns per-CLASS transit factors (water/mass/momentum); `classes`
    maps the carried channels (water, mass, vel_x, vel_y[, albedo rgb])
    to those classes; `contractive` declares every factor <= 1."""

    kind = "fluvial"

    def __init__(self, p, Llen, albedo_on=None):
        self.kd = p.depositionRateFluvial * 1.33   # erosion.cu:69
        self.nu = p.viscosityWater
        self.tau = p.bedShearWater
        self.evap = p.evapRate
        self.Llen = Llen
        self.albedo_on = p.trackAlbedo if albedo_on is None else albedo_on
        # albedo shares the mass attenuation (erosion.cu:111-113).
        self.classes = (0, 1, 2, 2) + ((1, 1, 1) if self.albedo_on else ())
        self.contractive = bool(self.evap >= 0.0 and self.kd >= 0.0)

    def __call__(self, dL, inv, w, carried, unit2, aux):
        ux, uy = unit2
        rate_v = aux[0]  # static per-cell momentum-decay rate (<= 0)
        w1 = 1.0 / (1.0 + dL * (self.tau + self.nu))
        fac_w = torch.exp(-torch.clamp(dL * inv * self.evap, max=88.0))
        fac_m = torch.exp(-torch.clamp(dL * inv * self.kd, max=88.0))
        fac_v = expected_exp_step(ux, uy, rate_v)
        return w1, (fac_w, fac_m, fac_v)

    def kernel_scalars(self):
        """(tau + nu, evapRate, kd), formed in double as the JAX code
        forms them; csrc/cohort_round.cu `CohortParams.r`."""
        return (self.tau + self.nu, self.evap, self.kd)


def make_fluvial_rules(p, Llen, albedo_on=None):
    """The fluvial cohort physics callback (see FluvialRules)."""
    return FluvialRules(p, Llen, albedo_on)


def _fluvial_cohort(t, rainfall, discharge, p, iters, halo=NO_HALO):
    """Age-structured cohort solve of the fluvial transport — the default
    field method. Returns (7, W, H) deposits (4 with albedo off)."""
    speed = t["speed"]
    Llen = t["Llen"]
    A = t["A"]
    accel = t["E_v"] / A + t["force"][:, None, None]
    rules = make_fluvial_rules(p, Llen)

    W, H = discharge.shape
    bd = _birth_density(W, H, halo=halo, device=discharge.device)
    carried0 = [bd * t["E_w"], bd * t["E_m"], bd * t["E_v"][0],
                bd * t["E_v"][1]]
    if t["E_a"] is not None:
        carried0 += [bd * t["E_a"][0], bd * t["E_a"][1], bd * t["E_a"][2]]
    # Static per-cell momentum-decay rate, hoisted out of the rounds.
    fD = p.frictionFactor / 8.0
    rate_v = torch.clamp(
        _sdiv(-Llen * 0.125 * fD, _EPS + discharge), -_RATE_CLIP, 0.0
    )
    aux = (accel[0], accel[1], torch.ones_like(discharge), rate_v)
    return _run_cohort_colored(halo, bd, speed, carried0, aux, rules,
                               iters, Llen, p.closure, tol=p.transportTol)


def _fluvial_field(t, discharge, p, iters, halo=NO_HALO):
    """Deterministic upwind fixed point of the fluvial transport operator
    (`transportMethod="field-static"`). Returns the flux tensor channel-
    first, (7, W, H) = (water, mass, vel_x, vel_y, albedo rgb) — 4 with
    albedo off — solved by `halo.run_transport` (the CUDA sweep on the
    card)."""
    speed = t["speed"]
    v_norm = _len2(speed[0], speed[1])
    alive = v_norm >= _EPS
    inv = 1.0 / torch.clamp(v_norm, min=_EPS)
    vx, vy = speed[0] * inv, speed[1] * inv

    step = stepsize_center(vx, vy)
    dL = step * t["Llen"]
    ds = dL * inv

    att_m = _masked_exp(alive, -ds * t["kd"])
    att_w = _masked_exp(alive, -ds * p.evapRate)
    att_v = _masked_exp(alive, -dL * 0.125 * t["fD"] / (_EPS + discharge))

    # Emissions carry the reference sampler's birth-density quirk; the
    # A*source terms of the normalize pass stay nominal (erosion.cu:163).
    bd = _birth_density(*t["E_w"].shape, halo=halo,
                        device=discharge.device)[None]
    parts = [t["E_w"][None], t["E_m"][None], t["E_v"]]
    atts = [att_w, att_m, att_v, att_v]
    if t["E_a"] is not None:
        parts.append(t["E_a"])
        atts += [att_m, att_m, att_m]
    E = bd * torch.cat(parts, dim=0)
    att = torch.stack(atts, dim=0)
    return halo.run_transport(E, att, vx, vy, iters)


# ---------------------------------------------------------------------------
# Debris transport
# ---------------------------------------------------------------------------


class DebrisRules:
    """The debris cohort physics callback (models/erosion.py
    `make_debris_rules` in the JAX package). `rho` = particles born per
    cell. The rule reads the per-particle carried mass carried[0]/(w rho),
    capped at 1e12, and returns factors (mass, momentum); `classes` maps
    (mass, vel_x, vel_y[, albedo rgb]). Not contractive: the suspension
    factor exceeds 1 above the yield-stress balance."""

    kind = "debris"
    contractive = False

    def __init__(self, p, Llen, rho, albedo_on=None):
        self.nu = p.viscosityDebris
        self.tau = p.bedShearDebris
        self.g = p.gravity
        self.kdd = p.depositionRateDebris
        self.kds = p.suspensionRateDebris
        self.tau_y = p.yieldStress
        self.rho = rho
        self.Llen = Llen
        self.albedo_on = p.trackAlbedo if albedo_on is None else albedo_on
        # albedo shares the mass factor (erosion.cu:311-321).
        self.classes = (0, 1, 1) + ((0, 0, 0) if self.albedo_on else ())

    def __call__(self, dL, inv, w, carried, unit2, aux):
        ux, uy = unit2
        excess0 = aux[0]
        M = carried[0]
        den = w * self.rho
        big = M > den * 1e12
        m_pp = torch.where(big, 1e12, M / torch.where(big, 1.0, den))
        debrisHeight = _EPS + m_pp
        decay = self.nu + _sdiv(self.tau, debrisHeight)
        w1 = 1.0 / (1.0 + dL * decay)

        excessStress = self.g * (excess0 - _sdiv(self.tau_y, debrisHeight))
        shearRate = torch.where(excessStress < 0.0, self.kdd, self.kds)
        fac_d = expected_exp_step(
            ux, uy,
            torch.clamp(self.Llen * inv * shearRate * excessStress * inv,
                        -_RATE_CLIP, _RATE_CLIP),
        )
        fac_v = expected_exp_step(
            ux, uy, torch.clamp(-self.Llen * decay, -_RATE_CLIP, 0.0)
        )
        return w1, (fac_d, fac_v)

    def kernel_scalars(self):
        """(rho, nu, tau, g, kdd, kds, yield stress); csrc/cohort_round.cu
        `CohortParams.r`."""
        return (self.rho, self.nu, self.tau, self.g, self.kdd, self.kds,
                self.tau_y)


def make_debris_rules(p, Llen, rho, albedo_on=None):
    """The debris cohort physics callback (see DebrisRules)."""
    return DebrisRules(p, Llen, rho, albedo_on)


def transport_debris(
    layers,
    mass,
    momentum,
    albedo_surface,
    scale,
    param: ErosionParams,
    *,
    method: str = None,
    key=None,
    iterations: int = None,
    halo=NO_HALO,
):
    """Debris-flow / landslide transport with Bingham-plastic-like
    rheology. Ref: erosion.cu:245-436.

    Args:
      layers: (2, W, H); mass: (W, H) previous debris field;
      momentum: (2, W, H); albedo_surface: (3, W, H).
      key: the particle method's torch.Generator (see transport_fluvial).
    Returns:
      (mass', momentum', albedo_transport') — channel-first.
    """
    p = param
    method = method or p.transportMethod
    # ("field-static" is a fluvial-only distinction; debris always runs
    # the cohort rheology.)
    if method not in ("field", "field-static", "particles"):
        raise ValueError(f"unknown transport method: {method!r}")
    if method == "particles":
        _check_single_device(halo)
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    A = sx * sy
    Llen = math.sqrt(sx * sx + sy * sy)

    theta = p.critSlopeBedrock
    nu = p.viscosityDebris
    g = p.gravity
    kl = p.landslideRateDebris

    grad = godunov_gradient(merged_height(layers), scale, p.exitSlope, halo)
    vel = momentum
    speed = -(g * grad) + nu * vel
    speed = speed / torch.sqrt(
        torch.clamp(_len2(sx * speed[0], sy * speed[1]), min=_EPS)
    )[None]

    excess0 = _len2(grad[0], grad[1]) - theta
    suspend = torch.clamp(kl * excess0, min=0.0)
    E_d = A * suspend
    E_v = A * (-(g * grad) + nu * vel)
    E_a = E_d[None] * albedo_surface if p.trackAlbedo else None

    if method == "particles":
        if key is None:
            key = seeded_generator(mass.device)
        Gcf = _debris_particles(
            layers, mass, momentum, albedo_surface, scale, p, key,
        ).reshape(6, *mass.shape)
    else:
        iters = iterations or (p.transportIterations
                               or max(p.maxage - 2, 1))
        # The newborn carried mass scales with particle density rho =
        # N/cells (Q = A*cells/N, erosion.cu:267), so the closure is
        # N-aware.
        W, H = mass.shape
        _, _, Wg, Hg = halo.global_offsets((W, H))
        rho = float(p.nSamples) / float(Wg * Hg)
        accel = E_v / A
        rules = make_debris_rules(p, Llen, rho)

        w0 = _birth_density(W, H, halo=halo, device=mass.device)
        carried0 = [w0 * E_d, w0 * E_v[0], w0 * E_v[1]]
        if E_a is not None:
            carried0 += [w0 * E_a[0], w0 * E_a[1], w0 * E_a[2]]
        aux = (accel[0], accel[1], torch.ones_like(excess0), excess0)
        Gcf = _run_cohort_colored(halo, w0, speed, carried0, aux, rules,
                                  iters, Llen, _debris_closure(p),
                                  tol=p.transportTol)

    G_d = Gcf[0]
    G_vx, G_vy = Gcf[1], Gcf[2]
    G_a = Gcf[3:6] if Gcf.shape[0] > 3 else None

    # Normalization (erosion.cu:353-393): fixed v=(1,0) -> norm = scale.y.
    norm = float(scale[1])
    mass_out = G_d / norm
    momentum_out = torch.stack(
        [(A * (-p.gravity * grad[0]) + G_vx) / norm,
         (A * (-p.gravity * grad[1]) + G_vy) / norm], dim=0
    )
    if G_a is None:
        albedo_out = albedo_surface  # untracked: identity pass-through
    else:
        has_mass = (G_d >= _TINY) & torch.any(G_a * G_a >= _TINY, dim=0)
        albedo_out = torch.where(
            has_mass[None], G_a / torch.clamp(G_d, min=_EPS)[None],
            albedo_surface,
        )
    return mass_out, momentum_out, albedo_out


# ---------------------------------------------------------------------------
# The Monte-Carlo particle estimators (transportMethod="particles")
# ---------------------------------------------------------------------------


def _check_single_device(halo):
    if halo is not NO_HALO:
        raise NotImplementedError(
            "method='particles' does not run with a sharded halo; use "
            "method='field' there")


def _flush(x):
    """x with its subnormal values set to 0 (see `_TINY`)."""
    return torch.where(torch.abs(x) < _TINY, 0.0, x)


def _particle_births(W, H, N, generator, device):
    """The reference sampler's births (erosion.cu:53-58): positions
    0.5 + u * (shape - 1) (the inset area, see `_birth_density`) and
    their x-major cells."""
    ux, uy = transport._birth_uniforms(N, generator, device)
    px = 0.5 + ux * (W - 1)
    py = 0.5 + uy * (H - 1)
    return px, py, px.to(torch.int64) * H + py.to(torch.int64)


def _particle_rounds(W, H, rounds, px, py, ind, spx, spy, alive, src, att,
                     Llen, advance):
    """The trajectory loop both estimators share (see
    `_particle_rounds_plain`), dispatched on the tensors' device: CUDA
    tensors launch the hand-written kernel (ops/particles.py,
    csrc/particle_rounds.cu; the physics from `advance`), CPU tensors run
    the plain loop; any other device raises. Returns the flux (C, W*H)."""
    if px.device.type == "cuda":
        return particles.particle_rounds_cuda(W, H, rounds, px, py, ind, spx,
                                              spy, alive, src, att, Llen,
                                              advance)
    if px.device.type != "cpu":
        raise ValueError(f"no particle rounds for device {px.device}")
    return _particle_rounds_plain(W, H, rounds, px, py, ind, spx, spy, alive,
                                  src, att, Llen, advance)


def _particle_rounds_plain(W, H, rounds, px, py, ind, spx, spy, alive, src,
                           att, Llen, advance):
    """The trajectory loop in plain torch: `rounds` times, the in-bounds
    test, the deposit of src * att[advance.sel] on entering a cell (ind
    updated first), then the DDA step along the unit speed and
    `advance(ind, dL, ds, v_safe, spx, spy, att, src)` ->
    (new speed x, new speed y, new att) at the updated cell. Dead
    particles keep their state. Shapes are static, so no round waits on
    the host. Returns the flux (C, W*H), a channel-first view of the
    cell-major flux the scatter adds to: one row a particle, 3.6x faster
    on an H100 than a scatter along a channel-first flux's cells
    (tools/particle_scatter.py)."""
    sel = device_constant(advance.sel, torch.int64, px.device)
    bx, by = _f32(W - 1e-3), _f32(H - 1e-3)
    flux = torch.zeros((W * H, src.shape[0]), dtype=torch.float32,
                       device=px.device)
    for _ in range(rounds):
        inb = (px >= 0) & (py >= 0) & (px < W) & (py < H)
        alive = alive & inb

        nind = (torch.clamp(px, 0.0, bx).to(torch.int64) * H
                + torch.clamp(py, 0.0, by).to(torch.int64))
        entered = alive & (nind != ind)
        ind = torch.where(entered, nind, ind)
        flux.index_add_(0, ind,
                        torch.where(entered, src * att[sel], 0.0).T)

        v_norm = torch.sqrt(spx * spx + spy * spy)  # = _len2, no autograd
        alive = alive & (v_norm >= _EPS)
        v_safe = torch.clamp(v_norm, min=_EPS)
        ux, uy = spx / v_safe, spy / v_safe
        stp = _stepsize_xy(px, py, ux, uy)
        dL = stp * Llen
        ds = dL / v_safe
        nsx, nsy, natt = advance(ind, dL, ds, v_safe, spx, spy, att, src)

        px = torch.where(alive, px + stp * ux, px)
        py = torch.where(alive, py + stp * uy, py)
        att = torch.where(alive, natt, att)
        spx = torch.where(alive, nsx, spx)
        spy = torch.where(alive, nsy, spy)
    return flux.T


def _unit_speed(spx, spy, sx, sy):
    """speed / sqrt(max(|L o speed|, EPS)): the reference's normalisation
    by the square root of a length (erosion.cu:77-79, kept)."""
    n = torch.sqrt(torch.clamp(_len2(sx * spx, sy * spy), min=_EPS))
    return spx / n, spy / n


def _particle_fields(layers, momentum, albedo_surface, scale, p, halo):
    """The estimators' per-cell lookups, flattened: the Godunov gradient
    (through `halo`), the momentum and the albedo."""
    W, H = layers.shape[-2:]
    grad = godunov_gradient(merged_height(layers), scale, p.exitSlope, halo)
    alb = torch.broadcast_to(albedo_surface, (3, W, H)).reshape(3, -1)
    return (grad[0].reshape(-1), grad[1].reshape(-1),
            momentum[0].reshape(-1), momentum[1].reshape(-1), alb)


class FluvialAdvance:
    """The fluvial estimator's round physics after the DDA step
    (within erosion.cu:29-141): at the particle's new cell `ind` the
    acceleration from the gradient, momentum and force, the implicit
    friction weight w1, and the attenuations of water (evaporation), mass
    (deposition) and momentum (friction over the discharge). Called as the
    plain round's `advance(ind, dL, ds, v_safe, spx, spy, att, src)` ->
    (new speed x, new speed y, new att); `lookups` are the per-cell fields
    it reads and `kernel_scalars()` its constants, for
    csrc/particle_rounds.cu. `sel`: the attenuation of each deposit
    (w, m, vx, vy, a0, a1, a2) under the attenuations (w, m, v)."""

    kind = "fluvial"
    sel = (0, 1, 2, 2, 1, 1, 1)

    def __init__(self, p, gx, gy, mx, my, dis):
        self.g = p.gravity
        self.nu = p.viscosityWater
        self.tau = p.bedShearWater
        self.evap = p.evapRate
        self.kd = p.depositionRateFluvial * 1.33
        self.fD = p.frictionFactor / 8.0
        self.fx, self.fy = float(p.force[0]), float(p.force[1])
        self.lookups = (gx, gy, mx, my, dis)

    def __call__(self, ind, dL, ds, v_safe, spx, spy, att, src):
        gx, gy, mx, my, dis = self.lookups
        g, nu = self.g, self.nu
        ax = -(g * gx[ind]) + nu * mx[ind] + self.fx
        ay = -(g * gy[ind]) + nu * my[ind] + self.fy
        w1 = _sdiv(1.0, 1.0 + dL * (self.tau + nu))
        decay_v = _sdiv(0.125 * self.fD, _EPS + dis[ind])
        natt = torch.stack([
            att[0] * torch.exp(-ds * self.evap),
            att[1] * torch.exp(-ds * self.kd),
            att[2] * torch.exp(-dL * decay_v),
        ])
        return w1 * spx + (dL * w1) * ax, w1 * spy + (dL * w1) * ay, natt

    def kernel_scalars(self):
        """(g, nu, force x, force y, tau + nu, fD / 8, evapRate, kd), each
        formed in double precision as `__call__` forms it;
        csrc/particle_rounds.cu `ParticleParams.r`."""
        return (self.g, self.nu, self.fx, self.fy, self.tau + self.nu,
                0.125 * self.fD, self.evap, self.kd)


def _fluvial_start(p, scale, Q, fields, rain, dis, cell):
    """The fluvial estimator's particles at birth in flat cells `cell` of
    the per-cell `fields` (`_particle_fields`), `rain` and `dis`: (unit
    speed x, y, alive, the 7 sources, the round's `advance`, a
    `FluvialAdvance`, whose `sel` gives each source's attenuation
    channel). Shared by the single-device
    and the sharded estimator (parallel/particles.py)."""
    sx, sy = float(scale[0]), float(scale[1])
    gx, gy, mx, my, alb = fields
    g = p.gravity
    nu = p.viscosityWater
    rho_w = p.densityWater
    ks = p.suspensionRateFluvial / 64.0
    fD = p.frictionFactor / 8.0
    alpha = p.fluvialExponent
    R = p.rainfall
    fx, fy = float(p.force[0]), float(p.force[1])

    v0x, v0y, g0x, g0y = mx[cell], my[cell], gx[cell], gy[cell]
    spx, spy = _unit_speed(-(g * g0x) + nu * v0x + fx,
                           -(g * g0y) + nu * v0y + fy, sx, sy)
    alive = _len2(spx, spy) >= _EPS

    v = _len2(v0x, v0y)
    shear = 0.125 * fD * rho_w * v * v
    # jnp.power, not _safe_pow: the estimator is not differentiated.
    power = torch.pow(torch.clamp(shear * _len2(g0x, g0y), min=0.0), alpha)
    source_m = Q * ks * power
    src = torch.cat([
        (Q * R * rain[cell])[None], source_m[None],
        (Q * (-(g * g0x) + nu * v0x))[None],
        (Q * (-(g * g0y) + nu * v0y))[None],
        source_m[None] * alb[:, cell],
    ])
    advance = FluvialAdvance(p, gx, gy, mx, my, dis)
    return spx, spy, alive, src, advance


def _fluvial_particles(
    layers, rainfall, discharge, momentum, albedo_surface, scale, p,
    generator,
):
    """Faithful vectorized MC fluvial transport (erosion.cu:29-141).

    Returns the expected-flux tensor G, channel-first (7, W*H) = (water,
    mass, vel2, albedo3): the reference normalization absorbs Q = 1/(P*N)
    into the per-particle source, so each particle deposits source-rate *
    A * Ncells / N. Births and per-cell lookups (`grad[ind]`,
    `momentum[ind]`, not bilinear) as the JAX package's."""
    W, H = discharge.shape
    sx, sy = float(scale[0]), float(scale[1])
    Llen = math.sqrt(sx * sx + sy * sy)
    N = int(p.nSamples)
    Q = sx * sy * W * H / N  # = 1/(P*N), P = 1/(A*elem)   (erosion.cu:53-54)
    fields = _particle_fields(layers, momentum, albedo_surface, scale, p,
                              NO_HALO)
    rain = torch.broadcast_to(rainfall, (W, H)).reshape(-1)

    px, py, ind = _particle_births(W, H, N, generator, discharge.device)
    spx, spy, alive, src, advance = _fluvial_start(
        p, scale, Q, fields, rain, discharge.reshape(-1), ind)
    # The reference loop `while(... && ++iter < maxage)` executes at most
    # maxage - 1 iterations (erosion.cu:101).
    att = torch.ones((3, N), dtype=torch.float32, device=discharge.device)
    return _particle_rounds(W, H, max(int(p.maxage) - 1, 0), px, py, ind,
                            spx, spy, alive, src, att, Llen, advance)


class DebrisAdvance:
    """The debris estimator's round physics after the DDA step
    (within erosion.cu:245-351; see `FluvialAdvance` for the interface). The
    carried mass sets the rheology (debrisHeight = EPS + att_d *
    source_d, with the CURRENT attenuation; source_d is row 0 of the
    sources, which travel with their particle), the shear rate follows
    the sign of the excess stress, and the mass factor exp(+decay_d) may
    grow without bound (to inf where the JAX package's does). `sel`: the
    attenuation of each deposit (d, vx, vy, a0, a1, a2) under the
    attenuations (d, v)."""

    kind = "debris"
    sel = (0, 1, 1, 0, 0, 0)

    def __init__(self, p, gx, gy, mx, my):
        self.theta = p.critSlopeBedrock
        self.nu = p.viscosityDebris
        self.tau = p.bedShearDebris
        self.g = p.gravity
        self.kdd = p.depositionRateDebris
        self.kds = p.suspensionRateDebris
        self.tau_y = p.yieldStress
        self.lookups = (gx, gy, mx, my)

    def __call__(self, ind, dL, ds, v_safe, spx, spy, att, src):
        gx, gy, mx, my = self.lookups
        g, nu = self.g, self.nu
        gpx, gpy = gx[ind], gy[ind]
        debrisHeight = _EPS + att[0] * src[0]
        ax = -(g * gpx) + nu * mx[ind]
        ay = -(g * gpy) + nu * my[ind]
        decay = nu + _sdiv(self.tau, debrisHeight)
        w1 = _sdiv(1.0, 1.0 + dL * decay)

        excess = torch.sqrt(gpx * gpx + gpy * gpy) - self.theta
        excessStress = g * (excess - _sdiv(self.tau_y, debrisHeight))
        shearRate = torch.where(excessStress < 0.0, self.kdd, self.kds)
        decay_d = ds * shearRate * excessStress / v_safe
        # The mass factor may die out and grow again (exp(+decay_d) is
        # not clamped). Where the JAX package's devices flush a subnormal
        # factor to 0 the particle's mass is gone for good (0 * e^x, or
        # NaN once e^x overflows); torch keeps subnormals, so the factor
        # and its product are flushed below the smallest normal float
        # here, as the JAX package's decisions on carried mass are
        # (ROADMAP C.2).
        natt = torch.stack([_flush(att[0] * _flush(torch.exp(decay_d))),
                            att[1] * torch.exp(-dL * decay)])
        return w1 * spx + (w1 * dL) * ax, w1 * spy + (w1 * dL) * ay, natt

    def kernel_scalars(self):
        """(g, nu, tau, theta, yield stress, kdd, kds, 0);
        csrc/particle_rounds.cu `ParticleParams.r`."""
        return (self.g, self.nu, self.tau, self.theta, self.tau_y, self.kdd,
                self.kds, 0.0)


def _debris_start(p, scale, Q, fields, cell):
    """The debris estimator's particles at birth (see `_fluvial_start`;
    the round's `advance` is a `DebrisAdvance`)."""
    sx, sy = float(scale[0]), float(scale[1])
    gx, gy, mx, my, alb = fields
    theta = p.critSlopeBedrock
    nu = p.viscosityDebris
    g = p.gravity
    kl = p.landslideRateDebris

    v0x, v0y, g0x, g0y = mx[cell], my[cell], gx[cell], gy[cell]
    spx, spy = _unit_speed(-(g * g0x) + nu * v0x, -(g * g0y) + nu * v0y,
                           sx, sy)
    alive = _len2(spx, spy) >= _EPS

    excess0 = _len2(g0x, g0y) - theta
    source_d = Q * torch.clamp(kl * excess0, min=0.0)
    src = torch.cat([
        source_d[None],
        (Q * (-(g * g0x) + nu * v0x))[None],
        (Q * (-(g * g0y) + nu * v0y))[None],
        source_d[None] * alb[:, cell],
    ])
    advance = DebrisAdvance(p, gx, gy, mx, my)
    return spx, spy, alive, src, advance


def _debris_particles(layers, mass, momentum, albedo_surface, scale, p,
                      generator):
    """Faithful vectorized MC debris transport (erosion.cu:245-351).
    Returns G channel-first (6, W*H) = (mass, vel2, albedo3); the physics
    in `_debris_start`."""
    W, H = mass.shape
    sx, sy = float(scale[0]), float(scale[1])
    Llen = math.sqrt(sx * sx + sy * sy)
    N = int(p.nSamples)
    Q = sx * sy * W * H / N
    fields = _particle_fields(layers, momentum, albedo_surface, scale, p,
                              NO_HALO)

    px, py, ind = _particle_births(W, H, N, generator, mass.device)
    spx, spy, alive, src, advance = _debris_start(p, scale, Q, fields, ind)
    # `++iter < maxage` -> maxage - 1 iterations.
    att = torch.ones((2, N), dtype=torch.float32, device=mass.device)
    return _particle_rounds(W, H, max(int(p.maxage) - 1, 0), px, py, ind,
                            spx, spy, alive, src, att, Llen, advance)


# ---------------------------------------------------------------------------
# Mass transfer + creep
# ---------------------------------------------------------------------------


def mass_transfer(
    delta,
    layers,
    uplift,
    discharge,
    mass,
    momentum,
    debris,
    momentum_debris,
    albedo_bedrock,
    albedo_transport_fluvial,
    albedo_transport_debris,
    albedo_surface,
    scale,
    param: ErosionParams,
    halo=NO_HALO,
):
    """Eulerian height-field update: fluvial suspend/deposit, debris
    suspend/deposit, uplift — stability-clamped, two-layer bookkeeping,
    surface-albedo mixing. Ref: __transfer (erosion.cu:453-611).

    Returns (delta', albedo_surface').
    """
    p = param
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    dt = p.timeStep
    ku = p.uplift
    kfs = p.suspensionRateFluvial / 64.0
    kfd = p.depositionRateFluvial * 1.33
    fD = p.frictionFactor / 8.0
    alpha = p.fluvialExponent
    rho = p.densityWater
    g = p.gravity
    tau_y = p.yieldStress
    kds = p.suspensionRateDebris
    kdd = p.depositionRateDebris
    kL = p.landslideRateDebris
    eps = _EPS

    grad = godunov_gradient(merged_height(layers), scale, p.exitSlope, halo)
    L = math.sqrt(sx * sx + sy * sy)
    slope = _len2(grad[0], grad[1])

    # Fluvial erosion (erosion.cu:496-506)
    v = _len2(momentum[0], momentum[1])
    shear = 0.125 * fD * rho * v * v
    power = _safe_pow(torch.clamp(shear * slope, min=0.0), alpha)
    suspend = kfs * power
    deposit = kfd * mass
    uplift_rate = ku * uplift

    # Debris erosion (erosion.cu:508-514)
    debrisHeight = debris
    excessSlope = slope - p.critSlopeBedrock
    shearLandslide = torch.clamp(kL * excessSlope, min=0.0)
    shearYield = g * (debrisHeight * excessSlope - tau_y)
    suspendDebris = shearLandslide + kds * torch.clamp(shearYield, min=0.0)
    depositDebris = torch.minimum(
        debrisHeight, torch.clamp(-kdd * shearYield, min=0.0))

    # Stability-clamped transfer (erosion.cu:526-528)
    transfer = dt * (deposit - suspend + depositDebris - suspendDebris)
    transfer = torch.maximum(transfer, -0.25 * L * slope)
    transfer = torch.clamp(transfer, max=0.25 * L * 0.3)

    # Two-layer bookkeeping (erosion.cu:530-547): deposition -> sediment,
    # erosion eats sediment then bedrock, uplift -> bedrock only.
    d_bed = delta[0] + dt * uplift_rate / sz
    d_sed = delta[1] + torch.clamp(transfer, min=0.0) / sz

    sed = layers[1]
    neg = transfer < 0.0
    limited = torch.maximum(-sed * sz, transfer)  # sediment portion (<= 0)
    residual = transfer - limited                 # bedrock portion  (<= 0)
    d_sed = d_sed + torch.where(neg, limited / sz, 0.0)
    d_bed = d_bed + torch.where(neg, residual / sz, 0.0)
    transfer_post = torch.where(neg, residual, transfer)

    delta_out = torch.stack([d_bed, d_sed], dim=0)

    # Surface / transport albedo mixing (erosion.cu:549-572).
    totalHeight = mass + debrisHeight
    if not p.trackAlbedo:
        return delta_out, albedo_surface  # untracked: identity

    mixDepth = 1.0
    wMass = torch.clamp(mass / torch.clamp(totalHeight, min=_EPS), max=1.0)
    colorTransport = torch.clamp(
        wMass[None] * albedo_transport_fluvial
        + (1.0 - wMass[None]) * albedo_transport_debris,
        max=1.0,
    )
    colorSurface = torch.clamp(albedo_surface, max=1.0)
    wSurf = torch.clamp(sed * sz, max=mixDepth)
    wTrsp = torch.clamp(transfer_post, min=eps)
    wmix = torch.clamp(wTrsp / (wTrsp + wSurf), max=1.0)
    colorMix = wmix[None] * colorTransport + (1.0 - wmix[None]) * colorSurface

    bare = torch.abs(sed) < _TINY
    depositing = (totalHeight >= _TINY) & (transfer_post > eps)
    albedo_out = torch.where(
        bare[None],
        albedo_bedrock,
        torch.where(depositing[None], colorMix, albedo_surface),
    )
    return delta_out, albedo_out


def mass_creep(delta, layers, scale, param: ErosionParams, halo=NO_HALO):
    """Thermal erosion / hillslope creep: symmetric rate-limited transfer
    of sediment between 4-neighbors, exactly mass-conservative by
    symmetry. Ref: __mass_creep (erosion.cu:633-727). Returns delta'."""
    p = param
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    critSlope = p.critSlopeSediment

    bed = layers[0]
    # Clamp-to-edge for a radius-1 shift reproduces the creep kernel's
    # clamp-to-self substitution (erosion.cu:655-658).
    sed = halo.pad(layers[1], "edge")
    h = (halo.pad(bed, "edge") + sed) * sz

    def pair_transfer(dx, dy, s):
        """Net gain at each cell from its (+dx, +dy) neighbor (may be <0)."""
        hn = _shift_self(h, dx, dy)
        sed_n = _shift_self(sed, dx, dy)
        gain = torch.clamp(
            torch.minimum(sed_n * sz, 0.5 * ((hn - h) - critSlope * s)),
            min=0.0,
        )
        loss = torch.clamp(
            torch.minimum(sed * sz, 0.5 * ((h - hn) - critSlope * s)),
            min=0.0,
        )
        return torch.where(hn > h, gain, -loss)

    t = (
        pair_transfer(+1, 0, sx)
        + pair_transfer(-1, 0, sx)
        + pair_transfer(0, +1, sy)
        + pair_transfer(0, -1, sy)
    )
    d_sed = delta[1] + 0.25 * halo.crop(t) / sz
    return torch.stack([delta[0], d_sed], dim=0)


def _shift_self(h, dx, dy):
    """Shift with boundary cells replaced by the center value (the creep
    kernel's oob -> l00 substitution, erosion.cu:655-658)."""
    W, H = h.shape[0], h.shape[1]
    shifted = torch.roll(h, shifts=(-dx, -dy), dims=(0, 1))
    x = torch.arange(W, device=h.device)[:, None] + dx
    y = torch.arange(H, device=h.device)[None, :] + dy
    oob = (x < 0) | (x >= W) | (y < 0) | (y >= H)
    return torch.where(oob, h, shifted)


# ---------------------------------------------------------------------------
# Albedo generators (in-sim visualization instrumentation), channel-first
# (3, W, H) colors. The colors given as 3-sequences go to the device of the
# fields.
# ---------------------------------------------------------------------------


def _color(c, like):
    return torch.as_tensor(c, dtype=torch.float32,
                           device=like.device)[:, None, None]


def albedo_stratum(uplift, layers, scale, param, colorA, colorB, age, freq):
    """Striped bedrock color from total uplift displacement.
    Ref: erosion.cu:794-854."""
    sz = float(scale[2])
    shift = age * param.uplift * uplift
    depth = torch.clamp(shift - layers[0] * sz, min=0.0)
    even = torch.floor(_div(depth, freq)).to(torch.int32) % 2 == 0
    return torch.where(even[None], _color(colorA, layers),
                       _color(colorB, layers))


def albedo_layer(albedo_bedrock, albedo_sediment, layers, scale_sediment,
                 shift_sediment):
    """Bedrock-sediment blend 1/(1 + scale*sed). Ref: erosion.cu:759-791."""
    cS = torch.clamp(albedo_sediment + torch.as_tensor(
        shift_sediment, dtype=torch.float32, device=layers.device), max=1.0)
    blend = _sdiv(1.0, 1.0 + scale_sediment * layers[1])
    return blend[None] * albedo_bedrock + (1.0 - blend[None]) * cS


def albedo_discharge(albedo, discharge, color_discharge, extinction, scale):
    """Extinction blend toward the water color. Ref: erosion.cu:857-919."""
    value = torch.clamp(discharge, min=0.0)
    blend = scale * (1.0 - torch.exp(-extinction * value))
    return blend[None] * _color(color_discharge, discharge) \
        + (1.0 - blend[None]) * albedo
