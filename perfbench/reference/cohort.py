"""The age-structured cohort solve at the default closure, in plain torch.

One round moves every cell's cohort one transit: the moments of its
velocity ensemble split into four directional streams (truncated
Gaussian marginals), quadrant-offset exit routing with the pooled
offset-conditional step moments, one evaluation of the physics rule a
cell, and a zero-boundary push of each payload one cell. Deposits are the
carried channels that arrive.

State layout, channel-first: [w, w*vx, w*vy, w*E[vx^2], w*E[vy^2],
w*E[vx*vy], w*E[fx], w*E[fy], w*E[fx^2], w*E[fy^2], carried...]; aux is
(accel_x, accel_y, domain mask, rule aux).

The operations and their order are those of the solve this benchmark
measures, so that in float32 both give the same bits where the measured
kernel is bitwise to its plain round; nothing here is imported from it.
Every constant takes the dtype of the state, so the same code runs as the
lower-precision control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-12
NSTATE = 10
OFF_WMIN = 0.05
SQRT2 = 1.4142135623730951
# Rounds between two reads of the adaptive exit (the measured solve's
# check granularity: it tests the criterion before rounds 0, 16, 32, ...).
TOL_CHECK_ROUNDS = 16


def stepsize_expected(vx, vy):
    """Mean first-crossing distance over a uniform in-cell position."""
    inv_s2 = 1.0 / SQRT2

    def axis(a):
        big = a >= inv_s2
        return torch.where(big, 0.5 / torch.where(big, a, 1.0), SQRT2 - a)

    return 0.5 * (axis(torch.abs(vx)) + axis(torch.abs(vy)))


def _expm1_k(x):
    small = torch.abs(x) < 0.01
    series = x * (1.0 + x * (0.5 + x * (1.0 / 6.0)))
    return torch.where(small, series, torch.exp(x) - 1.0)


def expected_exp_step(vx, vy, coef):
    """E[exp(coef * step)] over a uniform in-cell position, per axis at
    beta = coef / 2, exponents clipped to +-40."""
    def axis_mgf(a, beta):
        tiny_a = a < 1e-20
        a_s = torch.where(tiny_a, 1.0, a)
        u_star = torch.clamp(SQRT2 * a, max=1.0)
        arg = torch.clamp(beta * u_star / a_s, -40.0, 40.0)
        small_b = torch.abs(beta) < 1e-12
        beta_s = torch.where(small_b, 1.0, beta)
        integral = torch.where(
            small_b, u_star, (a_s / beta_s) * _expm1_k(arg))
        cap = torch.exp(torch.clamp(SQRT2 * beta, -40.0, 40.0))
        tail = torch.clamp(1.0 - SQRT2 * a, min=0.0) * cap
        full = integral + tail
        return torch.where(tiny_a, cap, full)

    beta = 0.5 * coef
    return axis_mgf(torch.abs(vx), beta) * axis_mgf(torch.abs(vy), beta)


def shift_push(payloads):
    """Sum at (x, y) of the +x payload of (x-1, y), the -x payload of
    (x+1, y), the +y payload of (x, y-1) and the -y payload of (x, y+1);
    payloads leaving the grid are dropped; None is a zero."""

    def shift_from(a, dx, dy):
        ap = F.pad(a, (max(0, dy), max(0, -dy), max(0, dx), max(0, -dx)))
        W, H = a.shape[-2], a.shape[-1]
        x0, y0 = max(0, -dx), max(0, -dy)
        return ap[..., x0:x0 + W, y0:y0 + H]

    pxp, pxn, pyp, pyn = payloads
    terms = []
    if pxp is not None:
        terms.append(shift_from(pxp, +1, 0))
    if pxn is not None:
        terms.append(shift_from(pxn, -1, 0))
    if pyp is not None:
        terms.append(shift_from(pyp, 0, +1))
    if pyn is not None:
        terms.append(shift_from(pyn, 0, -1))
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _norm_cdf(z, gauss):
    """Standard-normal CDF by the Abramowitz-Stegun 7.1.26 erf."""
    x = torch.abs(z) * 0.7071067811865476
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf_abs = 1.0 - poly * gauss
    erf_z = torch.sign(z) * erf_abs
    return 0.5 * (1.0 + erf_z)


def _axis_streams(mu, m2):
    """Truncated-Gaussian split of one axis into its positive- and
    negative-going streams: (E[v+], E[v-], E[v|v>0], E[v|v<0],
    E[v^2|v>0], E[v^2|v<0], P(v>0))."""
    var = torch.clamp(m2 - mu * mu, min=0.0)
    small = var <= 1e-12 * torch.clamp(m2, min=EPS)
    sigma = torch.where(small, 0.0, torch.sqrt(torch.where(small, 1.0, var)))
    sigma_s = torch.where(small, 1.0, sigma)
    z = torch.clamp(mu / sigma_s, -6.0, 6.0)
    gauss = torch.exp(-0.5 * z * z)
    phi = gauss * 0.3989422804014327
    Phi = torch.clamp(_norm_cdf(z, gauss), 1e-9, 1.0)
    Phn = torch.clamp(1.0 - Phi, 1e-9, 1.0)

    Epos = torch.where(small, torch.clamp(mu, min=0.0),
                       torch.clamp(mu * Phi + sigma * phi, min=0.0))
    Eneg = torch.clamp(Epos - mu, min=0.0)

    lam_p = phi / Phi
    lam_n = phi / Phn
    c_pos = torch.where(small, mu, mu + sigma * lam_p)
    c_neg = torch.where(small, mu, mu - sigma * lam_n)
    m2_pos = torch.where(small, m2, mu * mu + var + mu * sigma * lam_p)
    m2_neg = torch.where(small, m2, mu * mu + var - mu * sigma * lam_n)
    P_pos = torch.where(
        small,
        torch.where(mu > 0, 1.0, torch.where(mu < 0, 0.0, 0.5)),
        Phi,
    )
    return (Epos, Eneg, c_pos, c_neg, torch.clamp(m2_pos, min=0.0),
            torch.clamp(m2_neg, min=0.0), P_pos)


def _cond_stream(c_own, mu_t, m2_t):
    """Transverse moments of a stream without the cross-moment
    regression: (E[v_t], E[v_t^2] floored at its mean^2, E[v_own v_t])."""
    mt = mu_t
    m2t = torch.maximum(m2_t, mt * mt)
    return mt, m2t, mu_t * c_own


def _stream_geom(m2_own, m2_t):
    """(1/RMS speed, own-axis direction cosine, transverse cosine)."""
    zo = torch.clamp(m2_own, min=0.0)
    zt = torch.clamp(m2_t, min=0.0)
    s2 = zo + zt
    dead = s2 <= EPS * EPS
    inv_s = torch.where(dead, 1.0 / EPS,
                        1.0 / torch.sqrt(torch.where(dead, 1.0, s2)))
    zo_z = zo <= 0.0
    zt_z = zt <= 0.0
    u_own = torch.where(zo_z, 0.0,
                        torch.sqrt(torch.where(zo_z, 1.0, zo))) * inv_s
    u_t = torch.where(zt_z, 0.0,
                      torch.sqrt(torch.where(zt_z, 1.0, zt))) * inv_s
    return inv_s, u_own, u_t


def _trunc_step_moments(m, h, a):
    """(E[T], Var[T]) of T = min(g/a, sqrt2), g ~ U(max(0, m-h),
    min(1, m+h))."""
    lo = torch.clamp(m - h, min=0.0)
    hi = torch.clamp(m + h, max=1.0)
    inv_L = 1.0 / torch.clamp(hi - lo, min=1e-6)
    a_s = torch.clamp(a, min=1e-6)
    inv_a = 1.0 / a_s
    gs = torch.clamp(SQRT2 * a_s, lo, hi)
    w_lin = (gs - lo) * inv_L
    w_cap = (hi - gs) * inv_L
    e_lin = 0.5 * (lo + gs) * inv_a
    e2_lin = (gs * gs + gs * lo + lo * lo) * (inv_a * inv_a) * (1.0 / 3.0)
    et = w_lin * e_lin + w_cap * SQRT2
    et2 = w_lin * e2_lin + w_cap * 2.0
    return et, torch.clamp(et2 - et * et, min=0.0)


def _stream_advance(w1, dL, dvar, ax, ay, mx, my, m2x_, m2y_, mxy_):
    """Post-transit velocity moments of one stream."""
    dax, day = dL * ax, dL * ay
    w2 = w1 * w1
    vox = w1 * (mx + dax)
    voy = w1 * (my + day)
    m2xo = w2 * (m2x_ + 2.0 * dax * mx + dax * dax + dvar * (ax * ax))
    m2yo = w2 * (m2y_ + 2.0 * day * my + day * day + dvar * (ay * ay))
    mxyo = w2 * (mxy_ + dax * my + day * mx + dax * day + dvar * (ax * ay))
    return vox, voy, m2xo, m2yo, mxyo


def _round_payloads(st, aux, rules, Llen):
    """The four directional payloads of each output channel, in state
    order, then the carried deposits."""
    w = st[0]
    safe_w = torch.clamp(w, min=EPS)
    inv_w = 1.0 / safe_w
    vbx, vby = st[1] * inv_w, st[2] * inv_w
    m2x, m2y = st[3] * inv_w, st[4] * inv_w
    carried = st[NSTATE:]
    axl, ayl = aux[0], aux[1]

    srms_sq = m2x + m2y
    szero = srms_sq <= 0.0
    sbar = torch.where(szero, 0.0,
                       torch.sqrt(torch.where(szero, 1.0, srms_sq)))
    alive = (sbar >= EPS) & (w > 0.0) & (aux[2] > 0.0)

    Exp, Exn, cxp, cxn, m2xp, m2xn, Pxp = _axis_streams(vbx, m2x)
    Eyp, Eyn, cyp, cyn, m2yp, m2yn, Pyp = _axis_streams(vby, m2y)

    def sq(x):
        return x * x

    # Quadrant-offset exit routing.
    mfx = torch.clamp(st[6] * inv_w, 0.0, 1.0)
    mfy = torch.clamp(st[7] * inv_w, 0.0, 1.0)
    vfx = st[8] * inv_w - mfx * mfx
    vfy = st[9] * inv_w - mfy * mfy
    vmin = OFF_WMIN * OFF_WMIN / 12.0

    def width(v, m):
        v = torch.clamp(v, vmin, 1.0 / 12.0)
        wv = torch.sqrt(12.0 * v)
        return torch.clamp(
            torch.minimum(wv, 2.0 * torch.minimum(m, 1.0 - m)),
            min=OFF_WMIN)

    gwx = width(vfx, mfx)
    gwy = width(vfy, mfy)

    tiny = 1e-6
    uxp_m = torch.clamp(cxp, min=tiny)
    uxn_m = torch.clamp(-cxn, min=tiny)
    uyp_m = torch.clamp(cyp, min=tiny)
    uyn_m = torch.clamp(-cyn, min=tiny)
    hwx, hwy = 0.5 * gwx, 0.5 * gwy

    def quadrant(ux_m, uy_m, mgx, mgy):
        A = mgy * ux_m - mgx * uy_m
        Wu = gwy * ux_m + gwx * uy_m
        p_x = torch.clamp(0.5 + A / torch.clamp(Wu, min=tiny), 0.0, 1.0)
        c_y = torch.clamp(mgx * (uy_m / ux_m), max=1.0)
        lo_y = torch.clamp(c_y, mgy - hwy, mgy + hwy)
        gy_c = 0.5 * (lo_y + mgy + hwy)
        gy_out = torch.clamp(gy_c - c_y, 0.0, 1.0)
        v_gy = sq(mgy + hwy - lo_y) * (1.0 / 12.0)
        c_x = torch.clamp(mgy * (ux_m / uy_m), max=1.0)
        lo_x = torch.clamp(c_x, mgx - hwx, mgx + hwx)
        gx_c = 0.5 * (lo_x + mgx + hwx)
        gx_out = torch.clamp(gx_c - c_x, 0.0, 1.0)
        v_gx = sq(mgx + hwx - lo_x) * (1.0 / 12.0)
        return p_x, gy_out, gx_out, v_gy, v_gx

    mgx_p, mgx_n = 1.0 - mfx, mfx
    mgy_p, mgy_n = 1.0 - mfy, mfy
    Pxe_pp, gyo_pp, gxo_pp, vy_pp, vx_pp = quadrant(uxp_m, uyp_m, mgx_p,
                                                    mgy_p)
    Pxe_pn, gyo_pn, gxo_pn, vy_pn, vx_pn = quadrant(uxp_m, uyn_m, mgx_p,
                                                    mgy_n)
    Pxe_np, gyo_np, gxo_np, vy_np, vx_np = quadrant(uxn_m, uyp_m, mgx_n,
                                                    mgy_p)
    Pxe_nn, gyo_nn, gxo_nn, vy_nn, vx_nn = quadrant(uxn_m, uyn_m, mgx_n,
                                                    mgy_n)

    Pxn_, Pyn_ = 1.0 - Pxp, 1.0 - Pyp
    a_pp, a_pn = Pxp * Pyp, Pxp * Pyn_
    a_np, a_nn = Pxn_ * Pyp, Pxn_ * Pyn_

    q_pp_x, q_pn_x = a_pp * Pxe_pp, a_pn * Pxe_pn
    q_np_x, q_nn_x = a_np * Pxe_np, a_nn * Pxe_nn
    q_pp_y, q_pn_y = a_pp - q_pp_x, a_pn - q_pn_x
    q_np_y, q_nn_y = a_np - q_np_x, a_nn - q_nn_x

    wxp, wxn = q_pp_x + q_pn_x, q_np_x + q_nn_x
    wyp, wyn = q_pp_y + q_np_y, q_pn_y + q_nn_y

    pay_fx = (None, wxn,
              q_pp_y * (1.0 - gxo_pp) + q_np_y * gxo_np,
              q_pn_y * (1.0 - gxo_pn) + q_nn_y * gxo_nn)
    pay_fy = (q_pp_x * (1.0 - gyo_pp) + q_pn_x * gyo_pn,
              q_np_x * (1.0 - gyo_np) + q_nn_x * gyo_nn,
              None, wyn)
    pay_fx2 = (None, wxn,
               (q_pp_y * (sq(1.0 - gxo_pp) + vx_pp)
                + q_np_y * (sq(gxo_np) + vx_np)),
               (q_pn_y * (sq(1.0 - gxo_pn) + vx_pn)
                + q_nn_y * (sq(gxo_nn) + vx_nn)))
    pay_fy2 = ((q_pp_x * (sq(1.0 - gyo_pp) + vy_pp)
                + q_pn_x * (sq(gyo_pn) + vy_pn)),
               (q_np_x * (sq(1.0 - gyo_np) + vy_np)
                + q_nn_x * (sq(gyo_nn) + vy_nn)),
               None, wyn)

    # Transverse moments of each stream.
    my_xp, m2y_xp, mxy_xp = _cond_stream(cxp, vby, m2y)
    my_xn, m2y_xn, mxy_xn = _cond_stream(cxn, vby, m2y)
    mx_yp, m2x_yp, mxy_yp = _cond_stream(cyp, vbx, m2x)
    mx_yn, m2x_yn, mxy_yn = _cond_stream(cyn, vbx, m2x)

    # One evaluation of the rule at the pooled direction and RMS speed.
    ax = Exp + Exn
    ay = Eyp + Eyn
    inv_an = 1.0 / torch.sqrt(
        torch.clamp(ax * ax + ay * ay, min=EPS * EPS))
    ux = ax * inv_an
    uy = ay * inv_an
    dL = stepsize_expected(ux, uy) * Llen
    inv = 1.0 / torch.clamp(sbar, min=EPS)
    w1, facs = rules(dL, inv, safe_w, carried, (ux, uy), aux[3:])

    # Pooled offset-conditional step moments.
    mty = Pyp * mgy_p + (1.0 - Pyp) * mgy_n
    mtx = Pxp * mgx_p + (1.0 - Pxp) * mgx_n
    _, ux_r, uy_r = _stream_geom(m2x, m2y)
    et_x, vt_x = _trunc_step_moments(mtx, hwx, ux_r)
    et_y, vt_y = _trunc_step_moments(mty, hwy, uy_r)
    dLo = 0.5 * (et_x + et_y) * Llen
    dvar = 0.25 * (vt_x + vt_y) * (Llen * Llen)

    adv = [_stream_advance(w1, dLo, dvar, axl, ayl,
                           cxp, my_xp, m2xp, m2y_xp, mxy_xp),
           _stream_advance(w1, dLo, dvar, axl, ayl,
                           cxn, my_xn, m2xn, m2y_xn, mxy_xn),
           _stream_advance(w1, dLo, dvar, axl, ayl,
                           mx_yp, cyp, m2x_yp, m2yp, mxy_yp),
           _stream_advance(w1, dLo, dvar, axl, ayl,
                           mx_yn, cyn, m2x_yn, m2yn, mxy_yn)]

    wa = torch.where(alive, w, 0.0)
    wd = (wa * wxp, wa * wxn, wa * wyp, wa * wyn)

    yield wd
    for q in range(5):
        yield tuple(wd[d] * adv[d][q] for d in range(4))
    for pay in (pay_fx, pay_fy, pay_fx2, pay_fy2):
        yield tuple(None if p is None else wa * p for p in pay)

    classes = rules.classes
    nk = max(classes) + 1
    wz = [torch.where(alive, f, 0.0) for f in (wxp, wxn, wyp, wyn)]
    fw = [tuple(wz[d] * facs[k] for d in range(4)) for k in range(nk)]
    for c, k in zip(carried, classes):
        yield tuple(torch.clamp(c * f, -1e30, 1e30) for f in fw[k])


def cohort_round(st, G, aux, rules, Llen):
    """One transit: (the next state, G + the carried arrivals)."""
    out = [shift_push(t) for t in _round_payloads(st, aux, rules, Llen)]
    arrivals = torch.stack(out, dim=0)
    return arrivals, G + arrivals[NSTATE:]


def _converged(st, G, remaining, tol, contractive):
    """The adaptive exit: for contractive rules, live carried mass times
    the rounds left at most tol of the deposits' magnitude; otherwise no
    live carried mass at all (below the smallest normal float32)."""
    live = torch.sum(torch.abs(st[NSTATE:]), dim=(1, 2))
    if contractive:
        gauge = torch.sum(torch.abs(G), dim=(1, 2))
        return bool(torch.all(live * float(remaining) <= gauge * float(tol)))
    return bool(torch.all(live < torch.finfo(torch.float32).tiny))


def solve(st, aux, rules, iters, Llen, tol=0.0):
    """Deposits (C, W, H) of `iters` rounds from zero deposits; with tol >
    0 the solve stops at the first check (every TOL_CHECK_ROUNDS rounds,
    before the round) that finds it converged."""
    C = st.shape[0] - NSTATE
    G = torch.zeros((C,) + tuple(st.shape[1:]), dtype=st.dtype,
                    device=st.device)
    contractive = bool(rules.contractive)
    for i in range(int(iters)):
        if (tol > 0.0 and i % TOL_CHECK_ROUNDS == 0
                and _converged(st, G, float(iters) - i, tol, contractive)):
            break
        st, G = cohort_round(st, G, aux, rules, Llen)
    return G
