"""Steady-state transport solvers and the step-rule moments they share
(counterpart of `soillib_tpu/ops/transport.py`; reference:
model/path/path.cu).

The reference estimates steady states of linear conservation laws with
Monte-Carlo particles that drift along a velocity field with a DDA step
rule and deposit their attenuated source in every cell they enter
(path.cu:52-139). `solve_uniform(method="field")` evaluates the expected
value of that estimator as the fixed point of a linear upwind operator,

    G <- PUSH( att * (A*source + G) )

for `iterations` rounds (default W+H, the reference's Manhattan bound,
path.cu:200): ops/sweep.py, the hand-written CUDA sweep on the card.
`method="particles"` is the estimator itself, a vectorised port of
path.cu:52-139 in plain torch (gathers, elementwise rounds and
`index_add_` in place of the atomics; statically shaped, so a round puts
no device-to-host sync in the loop). Its uniforms come from a
`torch.Generator` on the field's device: deterministic in (seed, offset),
though not the JAX package's threefry numbers.

The cohort solve needs the moments of the DDA step over a uniformly
distributed within-cell position (`stepsize_*`, `expected_exp_step`).
The formulas, clips and branch points are the JAX package's, kept
exactly: the cohort kernel (csrc/cohort_round.cu) repeats them and is
held against this module.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from soillib_tpu_torch.core.device import as_field, seeded_generator
from soillib_tpu_torch.core.grid import check_channel_last
from soillib_tpu_torch.core.halo import NO_HALO
from soillib_tpu_torch.ops.noise import _div

_SQRT2 = math.sqrt(2.0)


def stepsize(pos, d):
    """Mean DDA cell-crossing distance in grid space (path.cu:27-49).

    pos: (..., 2) float grid positions; d: (..., 2) unit directions."""
    return _stepsize_xy(pos[..., 0], pos[..., 1], d[..., 0], d[..., 1])


def _stepsize_xy(px, py, dx, dy):
    """`stepsize` on component tensors (the particle rounds keep their
    state channel-first)."""
    x_neg = torch.floor(px)
    y_neg = torch.floor(py)

    # CUDA fmaxf/fminf return the non-NaN operand when one side is NaN
    # (0/0 arises when a coordinate sits exactly on a lattice line with a
    # zero direction component); so do torch.fmax/fmin, where
    # torch.maximum would propagate the NaN.
    sqrt2 = torch.full((), _SQRT2, dtype=px.dtype, device=px.device)
    tx = torch.fmin(torch.fmax((x_neg - px) / dx, (x_neg + 1.0 - px) / dx),
                    sqrt2)
    ty = torch.fmin(torch.fmax((y_neg - py) / dy, (y_neg + 1.0 - py) / dy),
                    sqrt2)
    return 0.5 * (tx + ty)


def stepsize_center(vx, vy):
    """The DDA step evaluated at cell centers (pos frac = 0.5): the
    per-cell mean crossing distance from unit-direction components.

    The small-component branch is double-where'd: min(0.5/a, sqrt2)
    equals sqrt2 exactly for a <= 0.5/sqrt2, and masking the division
    there keeps reverse mode free of 1/a^2 overflow (f32)."""
    def axis(a):
        capped = a <= 0.5 / _SQRT2
        return torch.where(capped, _SQRT2,
                           0.5 / torch.where(capped, 1.0, a))

    return 0.5 * (axis(torch.abs(vx)) + axis(torch.abs(vy)))


def stepsize_expected(vx, vy):
    """E_u[step] over a uniform within-cell position — the exact mean
    first-crossing distance of a uniformly-born particle: per axis with
    |d| = a, T = min(U/a, sqrt2), E[T] = 1/(2a) for a >= 1/sqrt2, else
    sqrt2 - a. Division masked for reverse-mode safety."""
    inv_s2 = 1.0 / _SQRT2

    def axis(a):
        big = a >= inv_s2
        return torch.where(big, 0.5 / torch.where(big, a, 1.0), _SQRT2 - a)

    return 0.5 * (axis(torch.abs(vx)) + axis(torch.abs(vy)))


def stepsize_var(vx, vy):
    """Var_u[step] over a uniform within-cell position, in the
    cancellation-free form
      Var[T] = (2*sqrt2/3)*a - a^2  for a < 1/sqrt2,
      Var[T] = 1/(12 a^2)           for a >= 1/sqrt2,
      Var[step] = (Var[Tx] + Var[Ty])/4."""
    def axis_var(a):
        big = a >= 1.0 / _SQRT2
        a_s = torch.where(big, a, 1.0)
        return torch.where(
            big, 1.0 / (12.0 * a_s * a_s), 0.9428090415820634 * a - a * a
        )

    return 0.25 * (axis_var(torch.abs(vx)) + axis_var(torch.abs(vy)))


def _expm1_k(x):
    """expm1 as the JAX kernel path computes it: cubic Taylor under
    |x| < 0.01, plain exp(x) - 1 elsewhere. Not `torch.expm1`: the cohort
    kernel and the JAX package use this decomposition, and the results
    must agree with both."""
    small = torch.abs(x) < 0.01
    series = x * (1.0 + x * (0.5 + x * (1.0 / 6.0)))
    return torch.where(small, series, torch.exp(x) - 1.0)


def expected_exp_step(vx, vy, coef):
    """E_u[exp(coef * step)] over a uniform within-cell position — the
    exact expected per-transit attenuation factor of a uniformly-born
    particle whose decay exponent is linear in the crossing distance:

      E[exp(beta T)] = (a/beta) expm1(beta u*/a) + max(0, 1-sqrt2 a) e^{sqrt2 beta}

    per axis at beta = coef/2, u* = min(1, sqrt2 a). Exponents are clipped
    to +-40 so the product of the two axis factors stays finite in f32.
    a -> 0 reduces to the pure sqrt2 cap."""
    def axis_mgf(a, beta):
        tiny_a = a < 1e-20
        a_s = torch.where(tiny_a, 1.0, a)
        u_star = torch.clamp(_SQRT2 * a, max=1.0)
        arg = torch.clamp(beta * u_star / a_s, -40.0, 40.0)
        small_b = torch.abs(beta) < 1e-12
        beta_s = torch.where(small_b, 1.0, beta)
        integral = torch.where(
            small_b, u_star, (a_s / beta_s) * _expm1_k(arg)
        )
        cap = torch.exp(torch.clamp(_SQRT2 * beta, -40.0, 40.0))
        tail = torch.clamp(1.0 - _SQRT2 * a, min=0.0) * cap
        full = integral + tail
        return torch.where(tiny_a, cap, full)

    beta = 0.5 * coef
    return axis_mgf(torch.abs(vx), beta) * axis_mgf(torch.abs(vy), beta)


def _bilinear_corners(W, H, x, y):
    """The corners, weights and out-of-bounds mask of a bilinear sample at
    positions (x, y) on a W x H grid, with sample_t<.,2,1>::gather's
    conventions (sample.hpp:155-186): integer-floor corners clipped into
    the grid, the +1 weight zeroed where x + 1 > W - 1 (resp. y), out of
    bounds outside [0, W-1] x [0, H-1]. Corners are int64 (the JAX
    package floors to int32; equal wherever a sample is in bounds)."""
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    wx = x - x0.to(x.dtype)
    wy = y - y0.to(y.dtype)

    # Far-edge clamp (sample.hpp:173-174): drop the +1 sample and weight.
    wx = torch.where(x + 1.0 > W - 1.0, 0.0, wx)
    wy = torch.where(y + 1.0 > H - 1.0, 0.0, wy)

    x0c = torch.clamp(x0, 0, W - 1)
    y0c = torch.clamp(y0, 0, H - 1)
    x1c = torch.clamp(x0 + 1, 0, W - 1)
    y1c = torch.clamp(y0 + 1, 0, H - 1)
    oob = (x < 0) | (y < 0) | (x > W - 1.0) | (y > H - 1.0)
    return x0c, y0c, x1c, y1c, wx, wy, oob


def bilinear_gather(field, pos):
    """Bilinear sample of a (W, H[, C]) field at (..., 2) grid positions.

    Mirrors sample_t<.,2,1>::gather (sample.hpp:155-186): integer-floor cell
    corners, NaN when pos is out of [0, W-1] x [0, H-1], weight zeroed at the
    far edge."""
    W, H = field.shape[0], field.shape[1]
    x0c, y0c, x1c, y1c, wx, wy, oob = _bilinear_corners(
        W, H, pos[..., 0], pos[..., 1])
    if field.dim() == 3:
        wx, wy, oob = wx[..., None], wy[..., None], oob[..., None]
    v = (
        field[x0c, y0c] * (1 - wx) * (1 - wy)
        + field[x0c, y1c] * (1 - wx) * wy
        + field[x1c, y0c] * wx * (1 - wy)
        + field[x1c, y1c] * wx * wy
    )
    return torch.where(oob, math.nan, v)


def linear_gather(field, pos):
    """1-D linear sample of a (N[, C]) field at (...,) positions —
    returns (value, gradient) with gradient in cell units.

    Mirrors sample_t<., 1, 1> (sample.hpp:32-66: val = lerp(v0, v1; t),
    grad = v1 - v0), with the 2-D gather's boundary conventions
    (sample.hpp:155-186) applied along the one axis: NaN outside
    [0, N-1], far-edge sample/weight dropped."""
    N = field.shape[0]
    x = pos
    x0 = torch.floor(x).to(torch.int64)
    t = x - x0.to(x.dtype)
    t = torch.where(x + 1.0 > N - 1.0, 0.0, t)
    v0 = field[torch.clamp(x0, 0, N - 1)]
    v1 = field[torch.clamp(x0 + 1, 0, N - 1)]
    oob = (x < 0) | (x > N - 1.0)
    if field.dim() == 2:
        t, oob = t[..., None], oob[..., None]
    val = v0 + t * (v1 - v0)
    grad = v1 - v0
    return torch.where(oob, math.nan, val), torch.where(oob, math.nan, grad)


def bilinear_gather_grad(field, pos):
    """Bilinear sample WITH its first-order gradient at (..., 2) grid
    positions of a (W, H) field -> (value, (..., 2) gradient), gradient in
    cell units.

    Mirrors sample_t<., 2, 1>::grad (sample.hpp:96-101): grad.x is the
    difference of the two y-lerped x-slices, grad.y the x-lerp of the
    per-slice y-differences; boundary conventions as `bilinear_gather`."""
    W, H = field.shape[0], field.shape[1]
    x0c, y0c, x1c, y1c, wx, wy, oob = _bilinear_corners(
        W, H, pos[..., 0], pos[..., 1])
    h00, h01 = field[x0c, y0c], field[x0c, y1c]
    h10, h11 = field[x1c, y0c], field[x1c, y1c]
    l0 = h00 + wy * (h01 - h00)
    l1 = h10 + wy * (h11 - h10)
    val = l0 + wx * (l1 - l0)
    gx = l1 - l0
    gy = (h01 - h00) + wx * ((h11 - h10) - (h01 - h00))
    nan = torch.where(oob, math.nan, 0.0)
    return val + nan, torch.stack([gx + nan, gy + nan], dim=-1)


def upwind_push(payload, dirs):
    """One round of the upwind transport operator, channel-last.

    payload: (W, H[, C]) quantity leaving each cell this round.
    dirs:    (W, H, 2) unit flow directions.
    Returns the quantity arriving at each cell: contributions from the four
    neighbors whose outflow points at it, split |vx| : |vy|. Outflow across
    the domain boundary is lost (particles exit, path.cu:104).
    """
    vx = dirs[..., 0]
    vy = dirs[..., 1]
    denom = torch.abs(vx) + torch.abs(vy)
    denom = torch.where(denom == 0.0, 1.0, denom)
    wx = torch.abs(vx) / denom
    wy = torch.abs(vy) / denom
    if payload.dim() == 3:
        wx, wy = wx[..., None], wy[..., None]
        vxm, vym = vx[..., None], vy[..., None]
    else:
        vxm, vym = vx, vy

    out_xp = torch.where(vxm > 0, payload * wx, 0.0)  # leaves toward +x
    out_xn = torch.where(vxm < 0, payload * wx, 0.0)  # leaves toward -x
    out_yp = torch.where(vym > 0, payload * wy, 0.0)
    out_yn = torch.where(vym < 0, payload * wy, 0.0)

    def shift_from(a, dx, dy):
        # arriving[x, y] = a[x - dx, y - dy] with zero inflow at the
        # boundary; F.pad takes last-dim pads first.
        pads = [0, 0] * (a.dim() - 2)
        pads += [max(0, dy), max(0, -dy), max(0, dx), max(0, -dx)]
        ap = F.pad(a, pads)
        Wd, Hd = a.shape[0], a.shape[1]
        x0, y0 = max(0, -dx), max(0, -dy)
        return ap[x0:x0 + Wd, y0:y0 + Hd, ...]

    return (
        shift_from(out_xp, +1, 0)
        + shift_from(out_xn, -1, 0)
        + shift_from(out_yp, 0, +1)
        + shift_from(out_yn, 0, -1)
    )


def _solve_field(flow, source, decay, scale, iterations, halo=NO_HALO):
    """Deterministic fixed-point evaluation of the expected MC flux."""
    A = float(scale[0]) * float(scale[1])
    L = math.sqrt(float(scale[0]) ** 2 + float(scale[1]) ** 2)

    fx, fy = flow[..., 0], flow[..., 1]
    v_len = torch.sqrt(fx * fx + fy * fy)
    alive = v_len > 0.0
    safe = torch.where(alive, v_len, 1.0)
    vx = fx / safe
    vy = fy / safe
    step = stepsize_center(vx, vy)
    dlam = step * L / safe
    att = torch.where(alive,
                      torch.exp(torch.where(alive, -dlam * decay, 0.0)), 0.0)

    emit = A * source  # expected per-cell source emission [X*m^D/s]

    # Channel-first solve (ops/sweep.py: the CUDA sweep on the card).
    E = emit.permute(2, 0, 1) if source.dim() == 3 else emit[None]
    E = E.contiguous()
    attc = torch.broadcast_to(att[None], E.shape).contiguous()
    G = halo.run_transport(E, attc, vx.contiguous(), vy.contiguous(),
                           iterations)
    return G.permute(1, 2, 0) if source.dim() == 3 else G[0]


def _f32(x: float) -> float:
    """x rounded to float32, as a Python float (a bound the JAX package
    builds as a float32 array)."""
    return float(np.float32(x))


def _birth_uniforms(n: int, generator, device):
    """The particle births' two draws, n uniforms in [0, 1) each, from
    `generator` on `device`, in program order. (One function, so that
    tests can inject the JAX package's threefry draws.) A generator on
    another device type raises: drawing on the host and copying over
    would hide where the estimator runs."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(
            f"the particle generator is on {generator.device} but the "
            f"fields are on {device}; make the generator on the fields' "
            f"device (torch.Generator(device=...))")
    return (torch.rand(n, generator=generator, device=device),
            torch.rand(n, generator=generator, device=device))


def _solve_particles(flow, source, decay, scale, count, generator, maxstep):
    """Faithful vectorized MC estimator (path.cu:52-139). The particle
    state is channel-first, the flux cell-major (W*H, K): the scatter
    adds each particle's K channels to one row (on an H100 3.6x faster
    than a scatter along the cells of a channel-first flux,
    tools/particle_scatter.py). Returns the flux over `count`, shaped as
    `source`."""
    W, H = flow.shape[0], flow.shape[1]
    dev = flow.device
    K = source.shape[2] if source.dim() == 3 else 1
    src = source.reshape(W * H, K)
    dec = decay.reshape(W * H)
    A = float(scale[0]) * float(scale[1])
    L = math.sqrt(float(scale[0]) ** 2 + float(scale[1]) ** 2)
    P = 1.0 / (A * W * H)
    eps = 1e-16
    bx, by = _f32(W - 1e-3), _f32(H - 1e-3)

    N = int(count)
    ux, uy = _birth_uniforms(N, generator, dev)
    px = ux * W
    py = uy * H
    ind = px.to(torch.int64) * H + py.to(torch.int64)
    S = _div(src[ind], P).T.contiguous()  # (K, N)
    alive = torch.sqrt(torch.sum(S * S, dim=0)) >= eps
    att = torch.ones(N, dtype=torch.float32, device=dev)
    flux = torch.zeros((W * H, K), dtype=torch.float32, device=dev)

    # `++step < maxstep` -> maxstep - 1 iterations (path.cu:104).
    for _ in range(max(maxstep - 1, 0)):
        inb = (px >= 0) & (py >= 0) & (px < W) & (py < H)
        alive = alive & inb & (eps < torch.abs(att))

        nind = (torch.clamp(px, 0.0, bx).to(torch.int64) * H
                + torch.clamp(py, 0.0, by).to(torch.int64))
        entered = alive & (nind != ind)
        ind = torch.where(entered, nind, ind)
        flux.index_add_(0, ind, torch.where(entered, S * att, 0.0).T)

        v = bilinear_gather(flow, torch.stack([px, py], dim=-1))
        v = torch.where(torch.isnan(v), 0.0, v)  # (N, 2), NaN fully OOB
        vx, vy = v[:, 0], v[:, 1]
        v_len = torch.sqrt(vx * vx + vy * vy)
        alive = alive & (v_len >= eps)

        v_safe = torch.clamp(v_len, min=1e-30)
        nx, ny = vx / v_safe, vy / v_safe
        stp = _stepsize_xy(px, py, nx, ny)
        dlam = stp * L / v_safe
        new_att = att * torch.exp(-dlam * dec[ind])

        px = torch.where(alive, px + stp * nx, px)
        py = torch.where(alive, py + stp * ny, py)
        att = torch.where(alive, new_att, att)

    G = _div(flux.reshape(W, H, K), float(count))
    return G if source.dim() == 3 else G[..., 0]


def solve_uniform(
    flow,
    source,
    decay,
    scale=(1.0, 1.0),
    count: int = None,
    *,
    method: str = "field",
    iterations: int = None,
    seed: int = 0,
    offset: int = 0,
    generator=None,
    halo=NO_HALO,
    device=None,
):
    """Steady-state solve of a linear conservation law along a flow field.

    Args:
      flow: (W, H, 2) velocity field [m/s].
      source: (W, H) or (W, H, K<=2) source rate [X/s].
      decay: (W, H) decay rate [1/s].
      scale: (sx, sy) cell widths [m].
      count: particle count (method="particles"); defaults to W*H.
      method: "field" (deterministic upwind fixed point) or "particles".
      iterations: field-method rounds; default W+H (the reference's
        Manhattan step bound, path.cu:200).
      seed, offset / generator: the particle method's random stream: a
        generator on the fields' device seeded from (seed, offset), or
        the caller's `generator` (which advances).
      device: where array-like inputs go (the card unless "cpu"); tensor
        inputs stay on their device.

    Returns:
      Normalized transported field, same shape as `source`.
      Ref: path.cu:180-219.
    """
    flow = as_field(flow, device)
    source = as_field(source, flow.device).to(flow.device)
    decay = as_field(decay, flow.device).to(flow.device)
    check_channel_last("flow", flow, channels=(2,))
    if source.dim() == 3 and source.shape[2] > 2:
        raise ValueError(
            f"source must be (W, H) or channel-LAST (W, H, K<=2); got "
            f"shape {tuple(source.shape)} (path.cu:192-214 dispatches on "
            f"the trailing channel dim)."
        )
    W, H = flow.shape[0], flow.shape[1]
    A = float(scale[0]) * float(scale[1])

    if method == "field":
        it = int(iterations) if iterations is not None else (W + H)
        G = _solve_field(flow, source, decay, scale, it, halo)
    elif method == "particles":
        if halo is not NO_HALO:
            raise NotImplementedError(
                "particle transport is single-device; use method='field' "
                "with a sharded halo")
        if generator is None:
            generator = seeded_generator(flow.device, seed, offset)
        n = int(count) if count is not None else W * H
        G = _solve_particles(flow, source, decay, scale, n, generator,
                             maxstep=W + H)
    else:
        raise ValueError(f"unknown method: {method!r}")

    norm = (torch.abs(flow[..., 0]) * float(scale[1])
            + torch.abs(flow[..., 1]) * float(scale[0]))
    norm = torch.where(norm == 0.0, math.inf, norm)  # zero flow -> 0/inf = 0
    if source.dim() == 3:
        norm = norm[..., None]
    return (source * A + G) / norm
