"""The coupled erosion step in plain torch: the benchmark's reference.

One step is

    fluvial transport -> debris transport -> lrate blend -> mass transfer
    -> creep -> layers + delta

over a dict of fields (the measured program's `ErosionState` fields by
name). Both transports are either the age-structured cohort solves at the
default closure (`transportMethod` "field", `cohort.solve`) or the
reference's Monte-Carlo particle estimators ("particles"), whose births
this module draws itself from a generator of the same seed.

The physics follows the upstream erosion.cu as the measured program
states it, quirks kept: ks/64, kd*1.33, fD/8, norm = scale.y, the
+-0.25*L transfer clamps, sediment-before-bedrock erosion, creep
symmetry. It imports nothing of the program. `p` is the configuration's
parameter dict. Every tensor it makes takes the dtype of the inputs, so
the same code computes the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import cohort

EPS = 1e-12
TINY = torch.finfo(torch.float32).tiny
RATE_CLIP = 1e4
FIELDS = ("layers", "rainfall", "uplift", "discharge", "mass", "momentum",
          "debris", "debris_momentum", "albedo_bedrock", "albedo_surface",
          "albedo_fluvial", "albedo_debris")


def _f32(x: float) -> float:
    return float(np.float32(x))


def _full(a, like):
    return torch.full((), a, dtype=like.dtype, device=like.device)


def _sdiv(a: float, t):
    """a / t as one division (not t.reciprocal() * a)."""
    return _full(a, t) / t


def _where_scalars(cond, a, b, like):
    return torch.where(cond, _full(a, like), _full(b, like))


def _shift(h, dx, dy, fill):
    pads = [max(0, -dy), max(0, dy), max(0, -dx), max(0, dx)]
    hp = F.pad(h, pads, value=fill)
    W, H = h.shape[0], h.shape[1]
    x0 = max(0, -dx) + dx
    y0 = max(0, -dy) + dy
    return hp[x0:x0 + W, y0:y0 + H]


def _len2(x, y):
    sq = x * x + y * y
    zero = sq == 0.0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))


def _safe_pow(x, alpha):
    zero = x == 0.0
    return torch.where(zero, 0.0, torch.pow(torch.where(zero, 1.0, x), alpha))


def birth_density(W, H, like):
    """Births are uniform over the inset (W-1) x (H-1) area: interior
    cells get W*H/((W-1)*(H-1)) of the nominal density, edges half of
    that, corners a quarter."""
    gx = torch.arange(W, device=like.device)
    gy = torch.arange(H, device=like.device)
    fx = torch.where((gx == 0) | (gx == W - 1), 0.5, 1.0).to(like.dtype) * (
        W / max(W - 1.0, 1.0))
    fy = torch.where((gy == 0) | (gy == H - 1), 0.5, 1.0).to(like.dtype) * (
        H / max(H - 1.0, 1.0))
    return fx[:, None] * fy[None, :]


def godunov_gradient(height, scale, exit_slope):
    """Steepest one-sided gradient per axis with the exit-slope boundary:
    the backward slope if the neighbour is lower, the forward one if it
    is higher, the steeper winning (backward on ties). (2, W, H)."""
    h = height
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

    return torch.stack([one_axis(hn0, hp0, sx), one_axis(h0n, h0p, sy)],
                       dim=0)


def _cohort_state(w0, speed0, carried0):
    return (w0, w0 * speed0[0], w0 * speed0[1],
            w0 * speed0[0] * speed0[0],
            w0 * speed0[1] * speed0[1],
            w0 * speed0[0] * speed0[1],
            w0 * 0.5, w0 * 0.5,
            w0 * (1.0 / 3.0), w0 * (1.0 / 3.0)) + tuple(carried0)


class FluvialRules:
    """Water, mass and momentum transit factors of one round."""

    contractive = True

    def __init__(self, p, albedo):
        self.kd = p["depositionRateFluvial"] * 1.33
        self.nu = p["viscosityWater"]
        self.tau = p["bedShearWater"]
        self.evap = p["evapRate"]
        self.classes = (0, 1, 2, 2) + ((1, 1, 1) if albedo else ())
        self.contractive = bool(self.evap >= 0.0 and self.kd >= 0.0)

    def __call__(self, dL, inv, w, carried, unit2, aux):
        ux, uy = unit2
        rate_v = aux[0]
        w1 = 1.0 / (1.0 + dL * (self.tau + self.nu))
        fac_w = torch.exp(-torch.clamp(dL * inv * self.evap, max=88.0))
        fac_m = torch.exp(-torch.clamp(dL * inv * self.kd, max=88.0))
        fac_v = cohort.expected_exp_step(ux, uy, rate_v)
        return w1, (fac_w, fac_m, fac_v)


class DebrisRules:
    """Debris mass and momentum transit factors (Bingham-like); not
    contractive."""

    contractive = False

    def __init__(self, p, Llen, rho, albedo):
        self.nu = p["viscosityDebris"]
        self.tau = p["bedShearDebris"]
        self.g = p["gravity"]
        self.kdd = p["depositionRateDebris"]
        self.kds = p["suspensionRateDebris"]
        self.tau_y = p["yieldStress"]
        self.rho = rho
        self.Llen = Llen
        self.classes = (0, 1, 1) + ((0, 0, 0) if albedo else ())

    def __call__(self, dL, inv, w, carried, unit2, aux):
        ux, uy = unit2
        excess0 = aux[0]
        M = carried[0]
        den = w * self.rho
        big = M > den * 1e12
        m_pp = torch.where(big, 1e12, M / torch.where(big, 1.0, den))
        debrisHeight = EPS + m_pp
        decay = self.nu + _sdiv(self.tau, debrisHeight)
        w1 = 1.0 / (1.0 + dL * decay)
        excessStress = self.g * (excess0 - _sdiv(self.tau_y, debrisHeight))
        shearRate = _where_scalars(excessStress < 0.0, self.kdd, self.kds,
                                   excessStress)
        fac_d = cohort.expected_exp_step(
            ux, uy,
            torch.clamp(self.Llen * inv * shearRate * excessStress * inv,
                        -RATE_CLIP, RATE_CLIP))
        fac_v = cohort.expected_exp_step(
            ux, uy, torch.clamp(-self.Llen * decay, -RATE_CLIP, 0.0))
        return w1, (fac_d, fac_v)


def _rounds(p):
    return int(p["transportIterations"] or max(int(p["maxage"]) - 2, 1))


def _fluvial_field(s, scale, p, grad, albedo):
    """Fluvial cohort solve -> deposits (7, W, H), 4 with albedo off."""
    sx, sy = float(scale[0]), float(scale[1])
    A = sx * sy
    Llen = math.sqrt(sx * sx + sy * sy)
    layers, dis, vel = s["layers"], s["discharge"], s["momentum"]
    g, nu, tau = p["gravity"], p["viscosityWater"], p["bedShearWater"]
    rho_w = p["densityWater"]
    ks = p["suspensionRateFluvial"] / 64.0
    fD = p["frictionFactor"] / 8.0
    force = torch.tensor(tuple(p["force"]), dtype=layers.dtype,
                         device=layers.device)

    speed = -(g * grad) + nu * vel + force[:, None, None]
    speed = speed / torch.sqrt(
        torch.clamp(_len2(sx * speed[0], sy * speed[1]), min=EPS))[None]
    v = _len2(vel[0], vel[1])
    shear = 0.125 * fD * rho_w * v * v
    power = _safe_pow(torch.clamp(shear * _len2(grad[0], grad[1]), min=0.0),
                      p["fluvialExponent"])
    E_m = A * ks * power
    E_w = torch.broadcast_to(A * p["rainfall"] * s["rainfall"], E_m.shape)
    E_v = A * (-(g * grad) + nu * vel)
    accel = E_v / A + force[:, None, None]

    W, H = dis.shape
    bd = birth_density(W, H, dis)
    carried0 = [bd * E_w, bd * E_m, bd * E_v[0], bd * E_v[1]]
    if albedo:
        E_a = E_m[None] * s["albedo_surface"]
        carried0 += [bd * E_a[0], bd * E_a[1], bd * E_a[2]]
    rate_v = torch.clamp(
        _sdiv(-Llen * 0.125 * fD, EPS + dis), -RATE_CLIP, 0.0)
    aux = torch.stack((accel[0], accel[1], torch.ones_like(dis), rate_v))
    st0 = torch.stack(_cohort_state(bd, speed, carried0))
    return cohort.solve(st0, aux, FluvialRules(p, albedo), _rounds(p), Llen,
                        tol=p["transportTol"])


def _debris_field(s, scale, p, grad, albedo):
    """Debris cohort solve -> deposits (6, W, H), 3 with albedo off."""
    sx, sy = float(scale[0]), float(scale[1])
    A = sx * sy
    Llen = math.sqrt(sx * sx + sy * sy)
    g, nu = p["gravity"], p["viscosityDebris"]
    vel = s["debris_momentum"]
    speed = -(g * grad) + nu * vel
    speed = speed / torch.sqrt(
        torch.clamp(_len2(sx * speed[0], sy * speed[1]), min=EPS))[None]
    excess0 = _len2(grad[0], grad[1]) - p["critSlopeBedrock"]
    E_d = A * torch.clamp(p["landslideRateDebris"] * excess0, min=0.0)
    E_v = A * (-(g * grad) + nu * vel)
    W, H = s["debris"].shape
    rho = float(p["nSamples"]) / float(W * H)
    accel = E_v / A
    w0 = birth_density(W, H, excess0)
    carried0 = [w0 * E_d, w0 * E_v[0], w0 * E_v[1]]
    if albedo:
        E_a = E_d[None] * s["albedo_surface"]
        carried0 += [w0 * E_a[0], w0 * E_a[1], w0 * E_a[2]]
    aux = torch.stack((accel[0], accel[1], torch.ones_like(excess0),
                       excess0))
    st0 = torch.stack(_cohort_state(w0, speed, carried0))
    return cohort.solve(st0, aux, DebrisRules(p, Llen, rho, albedo),
                        _rounds(p), Llen, tol=p["transportTol"])


# ---------------------------------------------------------------------------
# The Monte-Carlo particle estimators
# ---------------------------------------------------------------------------


def _flush(x):
    return torch.where(torch.abs(x) < TINY, 0.0, x)


def _stepsize_xy(px, py, dx, dy):
    """Mean DDA cell-crossing distance from positions and unit
    directions; fmax/fmin keep the non-NaN side, as CUDA's do."""
    x_neg = torch.floor(px)
    y_neg = torch.floor(py)
    sqrt2 = _full(math.sqrt(2.0), px)
    tx = torch.fmin(torch.fmax((x_neg - px) / dx, (x_neg + 1.0 - px) / dx),
                    sqrt2)
    ty = torch.fmin(torch.fmax((y_neg - py) / dy, (y_neg + 1.0 - py) / dy),
                    sqrt2)
    return 0.5 * (tx + ty)


def births(W, H, N, generator, like):
    """Positions 0.5 + u * (shape - 1) from two draws of N uniforms and
    their x-major cells."""
    ux = torch.rand(N, generator=generator, device=like.device)
    uy = torch.rand(N, generator=generator, device=like.device)
    px = 0.5 + ux.to(like.dtype) * (W - 1)
    py = 0.5 + uy.to(like.dtype) * (H - 1)
    # In float32 px < W - 0.5; the clamps only keep a lower precision's
    # rounding (to W) inside the grid.
    cell = (torch.clamp(px.to(torch.int64), max=W - 1) * H
            + torch.clamp(py.to(torch.int64), max=H - 1))
    return px, py, cell


def skip_births(N, generator, device, steps):
    """Advances `generator` past `steps` steps' births (two estimators,
    two draws each)."""
    for _ in range(4 * int(steps)):
        torch.rand(N, generator=generator, device=device)


def _particle_rounds(W, H, rounds, px, py, ind, spx, spy, alive, src, sel,
                     att, Llen, advance):
    """The trajectory loop: in-bounds test, the deposit of src * att[sel]
    on entering a cell, the DDA step along the unit speed, `advance`.
    Returns the flux (C, W*H)."""
    bx, by = _f32(W - 1e-3), _f32(H - 1e-3)
    flux = torch.zeros((W * H, src.shape[0]), dtype=src.dtype,
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
        v_norm = torch.sqrt(spx * spx + spy * spy)
        alive = alive & (v_norm >= EPS)
        v_safe = torch.clamp(v_norm, min=EPS)
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
    n = torch.sqrt(torch.clamp(_len2(sx * spx, sy * spy), min=EPS))
    return spx / n, spy / n


def _fluvial_particles(s, scale, p, grad, generator):
    """The fluvial estimator: (7, W*H) deposits (water, mass, momentum,
    albedo), Q = A * cells / N per particle."""
    dis = s["discharge"]
    W, H = dis.shape
    sx, sy = float(scale[0]), float(scale[1])
    Llen = math.sqrt(sx * sx + sy * sy)
    N = int(p["nSamples"])
    Q = sx * sy * W * H / N
    gx, gy = grad[0].reshape(-1), grad[1].reshape(-1)
    mx, my = s["momentum"][0].reshape(-1), s["momentum"][1].reshape(-1)
    alb = torch.broadcast_to(s["albedo_surface"], (3, W, H)).reshape(3, -1)
    rain = torch.broadcast_to(s["rainfall"], (W, H)).reshape(-1)
    disf = dis.reshape(-1)
    g, nu, tau = p["gravity"], p["viscosityWater"], p["bedShearWater"]
    rho_w = p["densityWater"]
    ks = p["suspensionRateFluvial"] / 64.0
    kd = p["depositionRateFluvial"] * 1.33
    fD = p["frictionFactor"] / 8.0
    evap = p["evapRate"]
    fx, fy = float(p["force"][0]), float(p["force"][1])

    px, py, cell = births(W, H, N, generator, dis)
    v0x, v0y, g0x, g0y = mx[cell], my[cell], gx[cell], gy[cell]
    spx, spy = _unit_speed(-(g * g0x) + nu * v0x + fx,
                           -(g * g0y) + nu * v0y + fy, sx, sy)
    alive = _len2(spx, spy) >= EPS
    v = _len2(v0x, v0y)
    shear = 0.125 * fD * rho_w * v * v
    power = torch.pow(torch.clamp(shear * _len2(g0x, g0y), min=0.0),
                      p["fluvialExponent"])
    source_m = Q * ks * power
    src = torch.cat([
        (Q * p["rainfall"] * rain[cell])[None], source_m[None],
        (Q * (-(g * g0x) + nu * v0x))[None],
        (Q * (-(g * g0y) + nu * v0y))[None],
        source_m[None] * alb[:, cell],
    ])
    sel = torch.tensor((0, 1, 2, 2, 1, 1, 1), dtype=torch.int64,
                       device=dis.device)

    def advance(ind, dL, ds, v_safe, spx, spy, att, src):
        ax = -(g * gx[ind]) + nu * mx[ind] + fx
        ay = -(g * gy[ind]) + nu * my[ind] + fy
        w1 = _sdiv(1.0, 1.0 + dL * (tau + nu))
        decay_v = _sdiv(0.125 * fD, EPS + disf[ind])
        natt = torch.stack([
            att[0] * torch.exp(-ds * evap),
            att[1] * torch.exp(-ds * kd),
            att[2] * torch.exp(-dL * decay_v),
        ])
        return w1 * spx + (dL * w1) * ax, w1 * spy + (dL * w1) * ay, natt

    att = torch.ones((3, N), dtype=dis.dtype, device=dis.device)
    return _particle_rounds(W, H, max(int(p["maxage"]) - 1, 0), px, py,
                            cell, spx, spy, alive, src, sel, att, Llen,
                            advance)


def _debris_particles(s, scale, p, grad, generator):
    """The debris estimator: (6, W*H) deposits (mass, momentum, albedo)."""
    deb = s["debris"]
    W, H = deb.shape
    sx, sy = float(scale[0]), float(scale[1])
    Llen = math.sqrt(sx * sx + sy * sy)
    N = int(p["nSamples"])
    Q = sx * sy * W * H / N
    gx, gy = grad[0].reshape(-1), grad[1].reshape(-1)
    mx = s["debris_momentum"][0].reshape(-1)
    my = s["debris_momentum"][1].reshape(-1)
    alb = torch.broadcast_to(s["albedo_surface"], (3, W, H)).reshape(3, -1)
    theta = p["critSlopeBedrock"]
    nu, tau, g = p["viscosityDebris"], p["bedShearDebris"], p["gravity"]
    kl = p["landslideRateDebris"]
    kdd, kds = p["depositionRateDebris"], p["suspensionRateDebris"]
    tau_y = p["yieldStress"]

    px, py, cell = births(W, H, N, generator, deb)
    v0x, v0y, g0x, g0y = mx[cell], my[cell], gx[cell], gy[cell]
    spx, spy = _unit_speed(-(g * g0x) + nu * v0x, -(g * g0y) + nu * v0y,
                           sx, sy)
    alive = _len2(spx, spy) >= EPS
    excess0 = _len2(g0x, g0y) - theta
    source_d = Q * torch.clamp(kl * excess0, min=0.0)
    src = torch.cat([
        source_d[None],
        (Q * (-(g * g0x) + nu * v0x))[None],
        (Q * (-(g * g0y) + nu * v0y))[None],
        source_d[None] * alb[:, cell],
    ])
    sel = torch.tensor((0, 1, 1, 0, 0, 0), dtype=torch.int64,
                       device=deb.device)

    def advance(ind, dL, ds, v_safe, spx, spy, att, src):
        gpx, gpy = gx[ind], gy[ind]
        debrisHeight = EPS + att[0] * src[0]
        ax = -(g * gpx) + nu * mx[ind]
        ay = -(g * gpy) + nu * my[ind]
        decay = nu + _sdiv(tau, debrisHeight)
        w1 = _sdiv(1.0, 1.0 + dL * decay)
        excess = torch.sqrt(gpx * gpx + gpy * gpy) - theta
        excessStress = g * (excess - _sdiv(tau_y, debrisHeight))
        shearRate = _where_scalars(excessStress < 0.0, kdd, kds,
                                   excessStress)
        decay_d = ds * shearRate * excessStress / v_safe
        natt = torch.stack([_flush(att[0] * _flush(torch.exp(decay_d))),
                            att[1] * torch.exp(-dL * decay)])
        return w1 * spx + (w1 * dL) * ax, w1 * spy + (w1 * dL) * ay, natt

    att = torch.ones((2, N), dtype=deb.dtype, device=deb.device)
    return _particle_rounds(W, H, max(int(p["maxage"]) - 1, 0), px, py,
                            cell, spx, spy, alive, src, sel, att, Llen,
                            advance)


# ---------------------------------------------------------------------------
# Normalisation, transfer, creep, the step
# ---------------------------------------------------------------------------


def _albedo_from(G_a, G_m, albedo_surface):
    has_mass = (G_m >= TINY) & torch.any(G_a * G_a >= TINY, dim=0)
    return torch.where(has_mass[None], G_a / torch.clamp(G_m, min=EPS)[None],
                       albedo_surface)


def mass_transfer(s, dis, mas, mom, deb, dmom, alb_f, alb_d, scale, p,
                  grad):
    """Height-field delta (2, W, H) and the new surface albedo."""
    layers = s["layers"]
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    dt = p["timeStep"]
    kfs = p["suspensionRateFluvial"] / 64.0
    kfd = p["depositionRateFluvial"] * 1.33
    fD = p["frictionFactor"] / 8.0
    rho, g = p["densityWater"], p["gravity"]
    tau_y = p["yieldStress"]
    kds, kdd = p["suspensionRateDebris"], p["depositionRateDebris"]
    kL = p["landslideRateDebris"]

    L = math.sqrt(sx * sx + sy * sy)
    slope = _len2(grad[0], grad[1])
    v = _len2(mom[0], mom[1])
    shear = 0.125 * fD * rho * v * v
    power = _safe_pow(torch.clamp(shear * slope, min=0.0),
                      p["fluvialExponent"])
    suspend = kfs * power
    deposit = kfd * mas
    uplift_rate = p["uplift"] * s["uplift"]

    debrisHeight = deb
    excessSlope = slope - p["critSlopeBedrock"]
    shearLandslide = torch.clamp(kL * excessSlope, min=0.0)
    shearYield = g * (debrisHeight * excessSlope - tau_y)
    suspendDebris = shearLandslide + kds * torch.clamp(shearYield, min=0.0)
    depositDebris = torch.minimum(
        debrisHeight, torch.clamp(-kdd * shearYield, min=0.0))

    transfer = dt * (deposit - suspend + depositDebris - suspendDebris)
    transfer = torch.maximum(transfer, -0.25 * L * slope)
    transfer = torch.clamp(transfer, max=0.25 * L * 0.3)

    zero = torch.zeros_like(layers)
    d_bed = zero[0] + dt * uplift_rate / sz
    d_sed = zero[1] + torch.clamp(transfer, min=0.0) / sz
    sed = layers[1]
    neg = transfer < 0.0
    limited = torch.maximum(-sed * sz, transfer)
    residual = transfer - limited
    d_sed = d_sed + torch.where(neg, limited / sz, 0.0)
    d_bed = d_bed + torch.where(neg, residual / sz, 0.0)
    transfer_post = torch.where(neg, residual, transfer)
    delta = torch.stack([d_bed, d_sed], dim=0)

    albedo_surface = s["albedo_surface"]
    if not p["trackAlbedo"]:
        return delta, albedo_surface
    totalHeight = mas + debrisHeight
    wMass = torch.clamp(mas / torch.clamp(totalHeight, min=EPS), max=1.0)
    colorTransport = torch.clamp(
        wMass[None] * alb_f + (1.0 - wMass[None]) * alb_d, max=1.0)
    colorSurface = torch.clamp(albedo_surface, max=1.0)
    wSurf = torch.clamp(sed * sz, max=1.0)
    wTrsp = torch.clamp(transfer_post, min=EPS)
    wmix = torch.clamp(wTrsp / (wTrsp + wSurf), max=1.0)
    colorMix = wmix[None] * colorTransport + (1.0 - wmix[None]) * colorSurface
    bare = torch.abs(sed) < TINY
    depositing = (totalHeight >= TINY) & (transfer_post > EPS)
    albedo = torch.where(
        bare[None], s["albedo_bedrock"],
        torch.where(depositing[None], colorMix, albedo_surface))
    return delta, albedo


def _shift_self(h, dx, dy):
    W, H = h.shape[0], h.shape[1]
    shifted = torch.roll(h, shifts=(-dx, -dy), dims=(0, 1))
    x = torch.arange(W, device=h.device)[:, None] + dx
    y = torch.arange(H, device=h.device)[None, :] + dy
    oob = (x < 0) | (x >= W) | (y < 0) | (y >= H)
    return torch.where(oob, h, shifted)


def mass_creep(delta, layers, scale, p):
    """Symmetric rate-limited sediment exchange between 4-neighbours."""
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    crit = p["critSlopeSediment"]
    sed = layers[1]
    h = (layers[0] + sed) * sz

    def pair_transfer(dx, dy, s):
        hn = _shift_self(h, dx, dy)
        sed_n = _shift_self(sed, dx, dy)
        gain = torch.clamp(
            torch.minimum(sed_n * sz, 0.5 * ((hn - h) - crit * s)), min=0.0)
        loss = torch.clamp(
            torch.minimum(sed * sz, 0.5 * ((h - hn) - crit * s)), min=0.0)
        return torch.where(hn > h, gain, -loss)

    t = (pair_transfer(+1, 0, sx) + pair_transfer(-1, 0, sx)
         + pair_transfer(0, +1, sy) + pair_transfer(0, -1, sy))
    return torch.stack([delta[0], delta[1] + 0.25 * t / sz], dim=0)


def canonical(fields, p):
    """Compact (3, 1, 1) albedo fields broadcast to full size when albedo
    is tracked (they evolve)."""
    s = dict(fields)
    if p["trackAlbedo"]:
        W, H = s["layers"].shape[-2:]
        for f in ("albedo_surface", "albedo_fluvial", "albedo_debris"):
            if tuple(s[f].shape[-2:]) == (1, 1):
                s[f] = s[f].expand(3, W, H).contiguous()
    return s


@torch.no_grad()
def erode_step(fields, scale, p, generator=None):
    """One coupled step of `fields` (a dict of FIELDS) -> the next fields.
    `generator` draws the particle births (fluvial first, then debris)."""
    s = canonical(fields, p)
    albedo = bool(p["trackAlbedo"])
    sx, sy = float(scale[0]), float(scale[1])
    A = sx * sy
    norm = sy
    g = p["gravity"]
    height = s["layers"][0] + s["layers"][1]
    grad = godunov_gradient(height, scale, p["exitSlope"])
    W, H = s["discharge"].shape

    if p["transportMethod"] == "particles":
        Gf = _fluvial_particles(s, scale, p, grad, generator).reshape(7, W, H)
        Gd = _debris_particles(s, scale, p, grad, generator).reshape(6, W, H)
    elif p["transportMethod"] == "field":
        Gf = _fluvial_field(s, scale, p, grad, albedo)
        Gd = _debris_field(s, scale, p, grad, albedo)
    else:
        raise ValueError(f"no reference for transportMethod "
                         f"{p['transportMethod']!r}")

    force = torch.tensor(tuple(p["force"]), dtype=height.dtype,
                         device=height.device)
    sv_x = -g * grad[0] + force[0]
    sv_y = -g * grad[1] + force[1]
    dis = (A * p["rainfall"] * s["rainfall"] + Gf[0]) / norm
    mas = Gf[1] / norm
    mom = torch.stack([(A * sv_x + Gf[2]) / norm, (A * sv_y + Gf[3]) / norm],
                      dim=0)
    alb_f = (_albedo_from(Gf[4:7], Gf[1], s["albedo_surface"])
             if Gf.shape[0] > 4 else s["albedo_surface"])

    deb = Gd[0] / norm
    dmom = torch.stack([(A * (-g * grad[0]) + Gd[1]) / norm,
                        (A * (-g * grad[1]) + Gd[2]) / norm], dim=0)
    alb_d = (_albedo_from(Gd[3:6], Gd[0], s["albedo_surface"])
             if Gd.shape[0] > 3 else s["albedo_surface"])

    lr = p["lrate"]

    def blend(old, new):
        return (1.0 - lr) * old + lr * new

    dis = blend(s["discharge"], dis)
    mas = blend(s["mass"], mas)
    mom = blend(s["momentum"], mom)
    deb = blend(s["debris"], deb)
    dmom = blend(s["debris_momentum"], dmom)

    delta, alb_s = mass_transfer(s, dis, mas, mom, deb, dmom, alb_f, alb_d,
                                 scale, p, grad)
    delta = mass_creep(delta, s["layers"], scale, p)
    out = dict(s)
    out.update(layers=s["layers"] + delta, discharge=dis, mass=mas,
               momentum=mom, debris=deb, debris_momentum=dmom,
               albedo_surface=alb_s, albedo_fluvial=alb_f,
               albedo_debris=alb_d)
    return out
