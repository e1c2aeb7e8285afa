"""Age-structured cohort sweep: the plain torch rounds and the CUDA kernel
path (counterpart of `soillib_tpu/ops/cohort.py`).

The cohort transport (per-cell particle cohorts whose velocity/carried-
mass state evolves each transit, deposits accumulated on arrival) is a
nonlinear radius-1 stencil per round. `cohort_round` is one transit:
`_round_payloads` evaluates the per-cell physics into four directional
payloads per output channel, `shift_push` moves each payload one cell
(zero boundary: payloads leaving the domain are dropped, the reference
particle's `__oob` death, erosion.cu:281), and the carried-channel
arrivals add into the deposits G.

State layout (channel-first, as in the JAX package):
  st  = (NSTATE + C, W, H): [w, w*vx, w*vy, w*E[vx^2], w*E[vy^2],
                             w*E[vx*vy], w*E[fx], w*E[fy],
                             w*E[fx^2], w*E[fy^2], carried...]
  aux = (4, W, H): [accel_x, accel_y, domain mask, rules aux]
  G   = (C, W, H) accumulated arrival deposits.

`rules(dL, inv_speed, w, carried, (ux, uy), aux_tail)` is the physics
callback; it returns the implicit-Euler friction weight w1 and a tuple of
per-attenuation-CLASS transit factors; `rules.classes` maps each carried
channel to its factor class.

Closures: every `CohortClosure` the JAX package accepts. The physics
variants (`offsets`, `offstep` True/"stream"/False, `vdist` "gauss" or
"uniform", `xmom`, `perstream`) change `_round_payloads`; with
`closure.nodes` N in (2, 4) the state carries N full ensembles per cell
and arrivals are routed to a node by entry face or velocity-sign quadrant
(`_cohort_round_nodes`, node_rule "face" or "sign") or by the nearest
node mean (`_cohort_round_cluster`, "cluster" or "speed"); with
`closure.colors` M > 1 it carries M independent color groups (disjoint
birth sub-populations) whose deposits sum. A state is then colors x nodes
x (NSTATE + C) channels, color-major.

Two execution paths, chosen by the tensors' device in `run_cohort`:
  * CPU tensors: `cohort_advance_reference`, one plain round at a time.
  * CUDA tensors: `cohort_advance_cuda`, the hand-written Hopper kernels
    (csrc/cohort_round.cu): one-node, one-color solves run
    ROUNDS_PER_LAUNCH rounds per launch; node and color solves one launch
    per round and color group, the groups in order into the same
    deposits. It takes the rule sets this package defines (`rules.kind`
    "fluvial" or "debris") and raises on anything else. A closure other
    than the default physics and face routing runs a library built for
    it (`KernelVariant`). The kernels have no reverse mode: `run_cohort`
    goes through `DiffableCohort`, whose backward replays the plain rounds
    checkpointed per block, as the JAX package differentiates the solve.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from soillib_tpu_torch.core.graphs import count_on_device
from soillib_tpu_torch.ops.sweep import HALO_K, _vjp_checkpointed
from soillib_tpu_torch.ops.transport import stepsize_expected, stepsize_var

_EPS = 1e-12

# Moment channels ahead of the carried totals (see the module docstring).
NSTATE = 10

# Inferred-width floor for the sub-cell offset distributions.
_OFF_WMIN = 0.05

# Rounds between two reads of the adaptive exit criterion on the kernel
# path: the JAX kernel path's pass granularity (K = 16 rounds per pass).
TOL_CHECK_ROUNDS = 16

@dataclasses.dataclass(frozen=True)
class CohortClosure:
    """Closure configuration (hashable; see the JAX package's
    `CohortClosure` for what each field selects). Combinations the JAX
    package refuses raise `ValueError` where the solve runs (see
    `_check_closure`)."""

    offsets: bool = True
    offstep: object = True  # True (pooled) | "stream" | False
    vdist: str = "gauss"
    xmom: bool = False
    perstream: bool = False
    colors: int = 1
    color_rule: str = "dir"
    nodes: int = 1
    node_rule: str = "face"


def _env_closure() -> CohortClosure:
    """Process-default closure from the SOIL_COHORT_* env vars."""
    _ost = os.environ.get("SOIL_COHORT_OFFSTEP", "1")
    return CohortClosure(
        offsets=os.environ.get("SOIL_COHORT_OFFSETS", "1") == "1",
        offstep="stream" if _ost == "stream" else _ost == "1",
        vdist=os.environ.get("SOIL_COHORT_VDIST", "gauss"),
        xmom=os.environ.get("SOIL_COHORT_XMOM", "0") == "1",
        perstream=os.environ.get("SOIL_COHORT_PERSTREAM", "0") == "1",
        colors=int(os.environ.get("SOIL_COHORT_COLORS", "1")),
        color_rule=os.environ.get("SOIL_COHORT_COLOR_RULE", "dir"),
        nodes=int(os.environ.get("SOIL_COHORT_NODES", "1")),
        node_rule=os.environ.get("SOIL_COHORT_NODE_RULE", "face"),
    )


ENV_CLOSURE = _env_closure()


def _check_closure(closure) -> CohortClosure:
    """The closure in effect (None -> the env default). Raises ValueError
    where the JAX package refuses it: node_rule "sign" with nodes other
    than 4 or without offsets, "cluster" with nodes other than 4, "speed"
    with nodes other than 2, any other node count than 1, 2 or 4, and
    colors below 1. A node rule is read only with nodes > 1, as there."""
    cl = closure or ENV_CLOSURE
    nodes = int(cl.nodes or 1)
    if nodes > 1:
        rule = cl.node_rule
        if rule in ("sign", "cluster") and nodes != 4:
            raise ValueError(f"node_rule={rule!r} requires nodes=4")
        if rule == "speed" and nodes != 2:
            raise ValueError("node_rule='speed' requires nodes=2")
        if rule == "sign" and not cl.offsets:
            raise ValueError(
                "node_rule='sign' requires the offsets closure (the "
                "quadrant exit weights define the sign shares)")
    if nodes not in (1, 2, 4):
        raise ValueError(f"nodes must be 1, 2 or 4, got {nodes}")
    if int(cl.colors or 1) < 1:
        raise ValueError(f"colors must be >= 1, got {cl.colors}")
    return cl


def shift_push(payloads):
    """Zero-boundary directional push: `payloads` = (toward +x, -x, +y,
    -y) for one channel; the result at (x, y) sums the +x payload of
    (x-1, y), the -x payload of (x+1, y), the +y payload of (x, y-1) and
    the -y payload of (x, y+1), in that order. A `None` payload is a zero
    that is skipped."""

    def shift_from(a, dx, dy):
        # F.pad takes last-dim pads first: (y_lo, y_hi, x_lo, x_hi).
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
    """Standard-normal CDF via the Abramowitz-Stegun 7.1.26 rational erf
    approximation (max abs error 1.5e-7), as the JAX package computes it;
    `torch.erf` would not match it. `gauss` = exp(-z^2/2), shared with
    the caller's phi."""
    x = torch.abs(z) * 0.7071067811865476
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf_abs = 1.0 - poly * gauss
    erf_z = torch.sign(z) * erf_abs
    return 0.5 * (1.0 + erf_z)


def _axis_streams(mu, m2, vdist="gauss"):
    """Directional decomposition of a per-axis velocity ensemble with mean
    mu and raw second moment m2 into its positive- and negative-going
    streams.

    Returns (E[v+], E[v-], E[v|v>0], E[v|v<0], E[v^2|v>0], E[v^2|v<0],
    P(v>0)). Two marginal families (`CohortClosure.vdist`): "gauss", the
    truncated Gaussian, and "uniform", v ~ U[mu - sqrt(3) sigma,
    mu + sqrt(3) sigma] (bounded support, no exp or erf); any other value
    is "gauss", as in the JAX package."""
    var = torch.clamp(m2 - mu * mu, min=0.0)
    small = var <= 1e-12 * torch.clamp(m2, min=_EPS)
    sigma = torch.where(small, 0.0, torch.sqrt(torch.where(small, 1.0, var)))

    if vdist == "uniform":
        # Support [lo, hi], half-width sqrt(3) sigma, length L = hi - lo.
        s3 = 1.7320508075688772 * sigma
        lo, hi = mu - s3, mu + s3
        L = torch.where(small, 1.0, 2.0 * s3)
        inv_L = 1.0 / torch.clamp(L, min=_EPS)
        lo_p, hi_p = torch.clamp(lo, min=0.0), torch.clamp(hi, min=0.0)
        lo_n, hi_n = torch.clamp(lo, max=0.0), torch.clamp(hi, max=0.0)
        Epos = torch.where(small, torch.clamp(mu, min=0.0),
                           0.5 * (hi_p * hi_p - lo_p * lo_p) * inv_L)
        Eneg = torch.clamp(Epos - mu, min=0.0)
        c_pos = torch.where(small, mu, 0.5 * (lo_p + hi_p))
        c_neg = torch.where(small, mu, 0.5 * (lo_n + hi_n))
        third = 1.0 / 3.0
        m2_pos = torch.where(
            small, m2, third * (hi_p * hi_p + hi_p * lo_p + lo_p * lo_p))
        m2_neg = torch.where(
            small, m2, third * (hi_n * hi_n + hi_n * lo_n + lo_n * lo_n))
        P_pos = torch.where(
            small, torch.where(mu > 0, 1.0, torch.where(mu < 0, 0.0, 0.5)),
            torch.clamp(hi * inv_L, 0.0, 1.0))
        return Epos, Eneg, c_pos, c_neg, m2_pos, m2_neg, P_pos

    sigma_s = torch.where(small, 1.0, sigma)
    # |z| capped at 6: the minority stream's weight is < 1e-9 there.
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
    # Sign probability P(v > 0); the deterministic branch snaps to
    # {0, 1/2, 1} on sign(mu).
    P_pos = torch.where(
        small,
        torch.where(mu > 0, 1.0, torch.where(mu < 0, 0.0, 0.5)),
        Phi,
    )
    return (Epos, Eneg, c_pos, c_neg, torch.clamp(m2_pos, min=0.0),
            torch.clamp(m2_neg, min=0.0), P_pos)


def _cond_stream(c_own, m2_own, mu_own, mu_t, m2_t, b=None, var_own=None):
    """Transverse moments of a directional stream, (E[v_t|S], E[v_t^2|S],
    E[v_own*v_t|S]), conditioned on the own-axis truncation through the
    cross-moment regression v_t = mu_t + b (v_own - mu_own) + eps, with
    the m2 floor at mean^2. b = None is xmom off: the terms b multiplies
    are left out, not multiplied by zero (as in the JAX package)."""
    if b is None:
        mt = mu_t
        m2t = torch.maximum(m2_t, mt * mt)
        return mt, m2t, mu_t * c_own
    dmu = c_own - mu_own
    mt = mu_t + b * dmu
    ex2c = m2_own - 2.0 * mu_own * c_own + mu_own * mu_own
    m2t = m2_t + 2.0 * mu_t * b * dmu + b * b * (ex2c - var_own)
    m2t = torch.maximum(m2t, mt * mt)
    mxyc = mu_t * c_own + b * (m2_own - mu_own * c_own)
    return mt, m2t, mxyc


def _regress_coef(m2_own, var_own, cov):
    """cov / var_own, zero on a dispersion-free axis (double-where'd)."""
    small = var_own <= 1e-12 * torch.clamp(m2_own, min=_EPS)
    return torch.where(small, 0.0, cov / torch.where(small, 1.0, var_own))

def _stream_geom(m2_own, m2_t):
    """(1/RMS-speed, own-axis direction cosine, transverse cosine) from a
    stream's raw second moments. The square roots are double-where'd for
    reverse mode; the primals are the plain values.

    Where the JAX package calls rsqrt, this computes 1/sqrt (here and in
    `_round_payloads`): the CUDA kernel does the same, and `torch.rsqrt`
    on the card is an approximation that would part the two by an ulp."""
    zo = torch.clamp(m2_own, min=0.0)
    zt = torch.clamp(m2_t, min=0.0)
    s2 = zo + zt
    dead = s2 <= _EPS * _EPS
    inv_s = torch.where(dead, 1.0 / _EPS,
                        1.0 / torch.sqrt(torch.where(dead, 1.0, s2)))
    zo_z = zo <= 0.0
    zt_z = zt <= 0.0
    u_own = torch.where(zo_z, 0.0,
                        torch.sqrt(torch.where(zo_z, 1.0, zo))) * inv_s
    u_t = torch.where(zt_z, 0.0,
                      torch.sqrt(torch.where(zt_z, 1.0, zt))) * inv_s
    return inv_s, u_own, u_t


def _trunc_step_moments(m, h, a):
    """(E[T], Var[T]) of the per-axis crossing time T = min(g/a, sqrt2)
    with the distance-to-wall g ~ U(max(0, m-h), min(1, m+h))."""
    lo = torch.clamp(m - h, min=0.0)
    hi = torch.clamp(m + h, max=1.0)
    inv_L = 1.0 / torch.clamp(hi - lo, min=1e-6)
    a_s = torch.clamp(a, min=1e-6)
    inv_a = 1.0 / a_s
    gs = torch.clamp(1.4142135623730951 * a_s, lo, hi)
    w_lin = (gs - lo) * inv_L
    w_cap = (hi - gs) * inv_L
    e_lin = 0.5 * (lo + gs) * inv_a
    e2_lin = (gs * gs + gs * lo + lo * lo) * (inv_a * inv_a) * (1.0 / 3.0)
    et = w_lin * e_lin + w_cap * 1.4142135623730951
    et2 = w_lin * e2_lin + w_cap * 2.0
    return et, torch.clamp(et2 - et * et, min=0.0)


def _stream_advance(w1, dL, dvar, ax, ay, mx, my, m2x_, m2y_, mxy_):
    """Post-transit velocity moments of one stream: implicit-Euler
    friction weight w1 on (v + dL*a), with the crossing-distance variance
    dvar = Var[dL] injected into the second moments."""
    dax, day = dL * ax, dL * ay
    w2 = w1 * w1
    vox = w1 * (mx + dax)
    voy = w1 * (my + day)
    m2xo = w2 * (m2x_ + 2.0 * dax * mx + dax * dax + dvar * (ax * ax))
    m2yo = w2 * (m2y_ + 2.0 * day * my + day * day + dvar * (ay * ay))
    mxyo = w2 * (mxy_ + dax * my + day * mx + dax * day + dvar * (ax * ay))
    return vox, voy, m2xo, m2yo, mxyo


def cohort_round(st, G, aux, rules, Llen, closure=None):
    """One cohort transit: mix -> particle-state step -> push -> deposit.
    Returns (arrivals = the next state, G + the carried arrivals).

    With `closure.colors` M > 1 the M color groups go through one after
    another, G updated after each; with `closure.nodes` > 1 arrivals are
    routed to nodes by `closure.node_rule` (`_cohort_round_nodes`,
    `_cohort_round_cluster`)."""
    cl = _check_closure(closure)
    ncol = int(cl.colors or 1)
    if ncol > 1:
        P = st.shape[0] // ncol
        cl1 = dataclasses.replace(cl, colors=1)
        arrs = []
        for j in range(ncol):
            a, G = cohort_round(st[j * P:(j + 1) * P], G, aux, rules, Llen,
                                cl1)
            arrs.append(a)
        return torch.cat(arrs, dim=0), G
    nnodes = int(cl.nodes or 1)
    if nnodes > 1:
        if cl.node_rule in ("cluster", "speed"):
            return _cohort_round_cluster(st, G, aux, rules, Llen, cl, nnodes)
        return _cohort_round_nodes(st, G, aux, rules, Llen, cl, nnodes)
    out = [shift_push(t) for t in _round_payloads(st, aux, rules, Llen, cl)]
    arrivals = torch.stack(out, dim=0)
    return arrivals, G + arrivals[NSTATE:]


def _nadd(a, b):
    """Payload sum with None (a structural zero) skipped."""
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _cohort_round_nodes(st, G, aux, rules, Llen, cl, nnodes):
    """N-node mixture transit: the state carries `nnodes` full ensembles
    per cell ([node0 moments + carried, node1 ...]), each advanced with
    the single-ensemble physics. node_rule="face": arrivals go to a node
    by the face they entered through (nodes=2 separates x-crossers from
    y-crossers, nodes=4 every face). node_rule="sign" (nodes=4): every
    source node's face payloads are split by its velocity-sign quadrant
    shares ([++, +-, -+, --]) and each part goes to the node of its
    quadrant.

    Summation order (the CUDA kernel's too): each face's payloads are
    summed over the source nodes in node order before the push (for
    "sign", each node's payload times its share), a None (structural
    zero) payload skipped; a node whose faces are all None receives
    zeros; deposits are G + (node 0 + node 1 + ...)."""
    P = st.shape[0] // nnodes
    sign_rule = cl.node_rule == "sign"
    ratios = [None] * nnodes

    def sink(j):
        def put(r):
            ratios[j] = r
        return put

    gens = [_round_payloads(st[j * P:(j + 1) * P], aux, rules, Llen, cl,
                            ratio_sink=sink(j) if sign_rule else None)
            for j in range(nnodes)]

    def nmul(a, r):
        return None if a is None else a * r

    Z = torch.zeros_like(st[0])

    def pz(t):
        return Z if all(p is None for p in t) else shift_push(t)

    outs = [[] for _ in range(nnodes)]
    for ts in zip(*gens):
        if sign_rule:
            # Node order [++, +-, -+, --]: ++ receives the ++ share of
            # every +x payload and of every +y payload, and so on.
            acc = [[None] * 4 for _ in range(4)]
            for j, t in enumerate(ts):
                r = ratios[j]
                txp, txn, typ, tyn = t
                acc[0][0] = _nadd(acc[0][0], nmul(txp, r["xp"][0]))
                acc[1][0] = _nadd(acc[1][0], nmul(txp, r["xp"][1]))
                acc[2][1] = _nadd(acc[2][1], nmul(txn, r["xn"][0]))
                acc[3][1] = _nadd(acc[3][1], nmul(txn, r["xn"][1]))
                acc[0][2] = _nadd(acc[0][2], nmul(typ, r["yp"][0]))
                acc[2][2] = _nadd(acc[2][2], nmul(typ, r["yp"][1]))
                acc[1][3] = _nadd(acc[1][3], nmul(tyn, r["yn"][0]))
                acc[3][3] = _nadd(acc[3][3], nmul(tyn, r["yn"][1]))
            for k in range(4):
                outs[k].append(pz(tuple(acc[k])))
            continue
        xp, xn, yp, yn = ts[0]
        for t in ts[1:]:
            xp = _nadd(xp, t[0])
            xn = _nadd(xn, t[1])
            yp = _nadd(yp, t[2])
            yn = _nadd(yn, t[3])
        if nnodes == 2:
            outs[0].append(pz((xp, xn, None, None)))
            outs[1].append(pz((None, None, yp, yn)))
        else:
            outs[0].append(pz((xp, None, None, None)))
            outs[1].append(pz((None, xn, None, None)))
            outs[2].append(pz((None, None, yp, None)))
            outs[3].append(pz((None, None, None, yn)))
    arrivals = torch.stack([c for o in outs for c in o], dim=0)
    dep = torch.stack(outs[0][NSTATE:], dim=0)
    for j in range(1, nnodes):
        dep = dep + torch.stack(outs[j][NSTATE:], dim=0)
    return arrivals, G + dep


# Sign-quadrant prototype directions of the cluster rule ([++, +-, -+,
# --], unit vectors).
_PROTO = ((0.7071067811865476, 0.7071067811865476),
          (0.7071067811865476, -0.7071067811865476),
          (-0.7071067811865476, 0.7071067811865476),
          (-0.7071067811865476, -0.7071067811865476))


def _cluster_masks(arr, means, speed_mode):
    """The routing masks of the cluster and speed rules at the receiving
    cells: `arr[d]` = (w, w vx, w vy) of direction d's arrival, `means[j]`
    = (w, w vx, w vy) of node j's round-entry state. Returns masks[d][j],
    1.0 where direction d's arrival joins node j: the node whose mean
    velocity (speed, for "speed") is nearest, a dead node competing with
    its prototype scaled to the arrival's speed, the first node on ties.
    The CUDA kernel computes the same operations in the same order."""
    live = [m[0] > _EPS for m in means]
    inv_wj = [1.0 / torch.clamp(m[0], min=_EPS) for m in means]
    vjx = [m[1] * inv for m, inv in zip(means, inv_wj)]
    vjy = [m[2] * inv for m, inv in zip(means, inv_wj)]
    masks = []
    for wa, wx, wy in arr:
        inv_wa = 1.0 / torch.clamp(wa, min=_EPS)
        vax = wx * inv_wa
        vay = wy * inv_wa
        sa = torch.sqrt(torch.clamp(vax * vax + vay * vay, min=_EPS * _EPS))
        dists = []
        if speed_mode:
            # [fast, slow]: a dead fast node seeds at the arrival's own
            # speed, a dead slow one at a quarter of it.
            for j in range(2):
                sj = torch.sqrt(torch.clamp(vjx[j] * vjx[j] + vjy[j] * vjy[j],
                                            min=_EPS * _EPS))
                e = sa - sj
                dl = e * e
                f = sa - (sa if j == 0 else 0.25 * sa)
                dd = f * f
                dists.append(torch.where(live[j], dl, dd))
        else:
            for j, (px, py) in enumerate(_PROTO):
                ex, ey = vax - vjx[j], vay - vjy[j]
                dl = ex * ex + ey * ey
                fx, fy = vax - sa * px, vay - sa * py
                dd = fx * fx + fy * fy
                dists.append(torch.where(live[j], dl, dd))
        dmin = dists[0]
        for dj in dists[1:]:
            dmin = torch.minimum(dmin, dj)
        taken = None
        row = []
        for dj in dists:
            hit = dj <= dmin
            if taken is not None:
                hit = hit & ~taken
            row.append(torch.where(hit, 1.0, 0.0))
            taken = hit if taken is None else (taken | hit)
        masks.append(row)
    return masks


def _cohort_round_cluster(st, G, aux, rules, Llen, cl, nnodes):
    """N-node transit with similarity routing: node_rule="cluster"
    (nodes=4) or "speed" (nodes=2). Each direction's arrival, pooled over
    the source nodes (the face rule's sums), joins one target node by
    `_cluster_masks`; deposits are the direction sum of the carried
    arrivals (the masks partition each arrival). The masks multiply the
    arrivals, as in the JAX package: 0 x (-x) is -0.0 and 0 x inf NaN."""
    P = st.shape[0] // nnodes
    gens = [_round_payloads(st[j * P:(j + 1) * P], aux, rules, Llen, cl)
            for j in range(nnodes)]
    chans = []
    for ts in zip(*gens):
        xp, xn, yp, yn = ts[0]
        for t in ts[1:]:
            xp = _nadd(xp, t[0])
            xn = _nadd(xn, t[1])
            yp = _nadd(yp, t[2])
            yn = _nadd(yn, t[3])
        chans.append((xp, xn, yp, yn))

    def sh1(c, d):
        if c is None:
            return None
        t = [None] * 4
        t[d] = c
        return shift_push(tuple(t))

    shifted = [[sh1(ch[d], d) for ch in chans] for d in range(4)]
    masks = _cluster_masks([s[:3] for s in shifted],
                          [st[j * P:j * P + 3] for j in range(nnodes)],
                          cl.node_rule == "speed")
    Z = torch.zeros_like(st[0])
    arr_ch = []
    for j in range(nnodes):
        for c in range(P):
            acc = None
            for d in range(4):
                s = shifted[d][c]
                if s is not None:
                    term = masks[d][j] * s
                    acc = term if acc is None else acc + term
            arr_ch.append(Z if acc is None else acc)
    dep = []
    for c in range(NSTATE, P):
        acc = None
        for d in range(4):
            acc = _nadd(acc, shifted[d][c])
        dep.append(Z if acc is None else acc)
    return torch.stack(arr_ch, dim=0), G + torch.stack(dep, dim=0)


def _round_payloads(st, aux, rules, Llen, cl, ratio_sink=None):
    """Pre-shift directional payloads of one ensemble's transit round
    under the closure `cl` (see the JAX package's `_round_payloads` for
    the model of each variant).

    Yields, for each output channel in state-layout order (NSTATE moment
    channels, then the carried-total deposits), the 4-tuple of payloads
    pushed toward (+x, -x, +y, -y); `None` is a structural zero.
    `ratio_sink`, when given, receives before the first yield the
    per-face quadrant shares {face: (share_a, share_b)} of the sign rule
    (xp: ++/+-, xn: -+/--, yp: ++/-+, yn: +-/--).

    Where a variant leaves a term out (xmom off, the pooled or per-stream
    step moments replacing Var[dL]), it is not computed, as in the JAX
    package: the default closure's operations are exactly its own."""
    w = st[0]
    safe_w = torch.clamp(w, min=_EPS)
    inv_w = 1.0 / safe_w
    vbx, vby = st[1] * inv_w, st[2] * inv_w
    m2x, m2y = st[3] * inv_w, st[4] * inv_w
    mxy = st[5] * inv_w
    carried = st[NSTATE:]
    axl, ayl = aux[0], aux[1]
    offstep = cl.offsets and cl.offstep

    # RMS speed (non-cancelling).
    srms_sq = m2x + m2y
    szero = srms_sq <= 0.0
    sbar = torch.where(szero, 0.0,
                       torch.sqrt(torch.where(szero, 1.0, srms_sq)))
    alive = (sbar >= _EPS) & (w > 0.0) & (aux[2] > 0.0)

    Exp, Exn, cxp, cxn, m2xp, m2xn, Pxp = _axis_streams(vbx, m2x, cl.vdist)
    Eyp, Eyn, cyp, cyn, m2yp, m2yn, Pyp = _axis_streams(vby, m2y, cl.vdist)

    def sq(x):
        return x * x

    if cl.offsets:
        # Quadrant-offset exit routing: sign-quadrant weights from the
        # per-axis count probabilities, offsets as endpoint-anchored
        # uniforms in distance-to-wall coordinates.
        mfx = torch.clamp(st[6] * inv_w, 0.0, 1.0)
        mfy = torch.clamp(st[7] * inv_w, 0.0, 1.0)
        vfx = st[8] * inv_w - mfx * mfx
        vfy = st[9] * inv_w - mfy * mfy
        vmin = _OFF_WMIN * _OFF_WMIN / 12.0

        def width(v, m):
            v = torch.clamp(v, vmin, 1.0 / 12.0)
            wv = torch.sqrt(12.0 * v)
            return torch.clamp(
                torch.minimum(wv, 2.0 * torch.minimum(m, 1.0 - m)),
                min=_OFF_WMIN)

        gwx = width(vfx, mfx)
        gwy = width(vfy, mfy)

        tiny = 1e-6
        uxp_m = torch.clamp(cxp, min=tiny)
        uxn_m = torch.clamp(-cxn, min=tiny)
        uyp_m = torch.clamp(cyp, min=tiny)
        uyn_m = torch.clamp(-cyn, min=tiny)
        hwx, hwy = 0.5 * gwx, 0.5 * gwy

        def quadrant(ux_m, uy_m, mgx, mgy):
            """One sign quadrant: (P(x-exit), transverse-g mean after an
            x-exit, own-g mean after a y-exit, and their variances)."""
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

        if ratio_sink is not None:
            def shares(qa, qb, wf):
                z = wf <= 0.0
                inv = torch.where(z, 0.0, 1.0 / torch.where(z, 1.0, wf))
                return qa * inv, qb * inv

            ratio_sink({"xp": shares(q_pp_x, q_pn_x, wxp),
                        "xn": shares(q_np_x, q_nn_x, wxn),
                        "yp": shares(q_pp_y, q_np_y, wyp),
                        "yn": shares(q_pn_y, q_nn_y, wyn)})

        # Pushed f-offsets per face (w-normalized payload factors). The
        # own-axis offset resets to the entry face: 0 for + (a structural
        # zero, None), 1 for -.
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
    else:
        # Legacy dispersion split: the exit weights from the expected
        # positive and negative speeds, uniform offsets on every face.
        denom = Exp + Exn + Eyp + Eyn
        inv_denom = 1.0 / torch.where(denom <= 0.0, 1.0, denom)
        wxp, wxn = Exp * inv_denom, Exn * inv_denom
        wyp, wyn = Eyp * inv_denom, Eyn * inv_denom
        half, third = 0.5, 1.0 / 3.0
        pay_fx = pay_fy = (wxp * half, wxn * half, wyp * half, wyn * half)
        pay_fx2 = pay_fy2 = (wxp * third, wxn * third, wyp * third,
                             wyn * third)

    # Cross-moment regression coefficients (xmom; Cauchy-Schwarz-clamped
    # covariance). Off: None, and `_cond_stream` leaves their terms out.
    if cl.xmom:
        varx = torch.clamp(m2x - vbx * vbx, min=0.0)
        vary = torch.clamp(m2y - vby * vby, min=0.0)
        prod = varx * vary
        pzero = prod <= 0.0
        lim = torch.where(pzero, 0.0,
                          0.99 * torch.sqrt(torch.where(pzero, 1.0, prod)))
        cov = torch.clamp(mxy - vbx * vby, -lim, lim)
        bx = _regress_coef(m2x, varx, cov)
        by = _regress_coef(m2y, vary, cov)
    else:
        varx = vary = bx = by = None

    # Transverse moments of each stream.
    my_xp, m2y_xp, mxy_xp = _cond_stream(cxp, m2xp, vbx, vby, m2y, bx, varx)
    my_xn, m2y_xn, mxy_xn = _cond_stream(cxn, m2xn, vbx, vby, m2y, bx, varx)
    mx_yp, m2x_yp, mxy_yp = _cond_stream(cyp, m2yp, vby, vbx, m2x, by, vary)
    mx_yn, m2x_yn, mxy_yn = _cond_stream(cyn, m2yn, vby, vbx, m2x, by, vary)

    if cl.perstream:
        # The step rule and the rules evaluated once per directional
        # stream, at its own direction cosines and RMS speed.
        def stream_phys(m2_own, m2_t, own_is_x):
            inv_s, u_own, u_t = _stream_geom(m2_own, m2_t)
            u2 = (u_own, u_t) if own_is_x else (u_t, u_own)
            dL_s = stepsize_expected(*u2) * Llen
            dvar_s = None if offstep else (Llen * Llen) * stepsize_var(*u2)
            w1_s, facs_s = rules(dL_s, inv_s, safe_w, carried, u2, aux[3:])
            return dL_s, dvar_s, w1_s, facs_s

        ph = [stream_phys(m2xp, m2y_xp, True),
              stream_phys(m2xn, m2y_xn, True),
              stream_phys(m2x_yp, m2yp, False),
              stream_phys(m2x_yn, m2yn, False)]
    else:
        # One shared evaluation at the pooled dispersion-weighted
        # direction and pooled RMS speed.
        ax = Exp + Exn
        ay = Eyp + Eyn
        inv_an = 1.0 / torch.sqrt(
            torch.clamp(ax * ax + ay * ay, min=_EPS * _EPS))
        ux = ax * inv_an
        uy = ay * inv_an
        dL = stepsize_expected(ux, uy) * Llen
        dvar = None if offstep else (Llen * Llen) * stepsize_var(ux, uy)
        inv = 1.0 / torch.clamp(sbar, min=_EPS)
        w1, facs = rules(dL, inv, safe_w, carried, (ux, uy), aux[3:])
        ph = [(dL, dvar, w1, facs)] * 4

    if offstep:
        # Offset-conditional step moments replace (dL, Var[dL]) in the
        # velocity advance; the transverse wall distance mixes the two
        # sign populations by their count shares.
        mty = Pyp * mgy_p + (1.0 - Pyp) * mgy_n
        mtx = Pxp * mgx_p + (1.0 - Pxp) * mgx_n
        if cl.offstep == "stream":
            # Per-face-stream moments.
            def off_step(m_own, m_t, m2_own, m2_t, h_own, h_t):
                _, u_own, u_t = _stream_geom(m2_own, m2_t)
                et_o, vt_o = _trunc_step_moments(m_own, h_own, u_own)
                et_t, vt_t = _trunc_step_moments(m_t, h_t, u_t)
                return (0.5 * (et_o + et_t) * Llen,
                        0.25 * (vt_o + vt_t) * (Llen * Llen))

            steps = [off_step(mgx_p, mty, m2xp, m2y_xp, hwx, hwy),
                     off_step(mgx_n, mty, m2xn, m2y_xn, hwx, hwy),
                     off_step(mgy_p, mtx, m2yp, m2x_yp, hwy, hwx),
                     off_step(mgy_n, mtx, m2yn, m2x_yn, hwy, hwx)]
        else:
            # Pooled: one (dL, Var[dL]) per cell from the count-mixed
            # wall distances.
            _, ux_r, uy_r = _stream_geom(m2x, m2y)
            et_x, vt_x = _trunc_step_moments(mtx, hwx, ux_r)
            et_y, vt_y = _trunc_step_moments(mty, hwy, uy_r)
            steps = [(0.5 * (et_x + et_y) * Llen,
                      0.25 * (vt_x + vt_y) * (Llen * Llen))] * 4
        ph = [s + p[2:] for s, p in zip(steps, ph)]

    # Post-transit moments per stream (each at its own kinematics).
    adv = [_stream_advance(ph[0][2], ph[0][0], ph[0][1], axl, ayl,
                           cxp, my_xp, m2xp, m2y_xp, mxy_xp),
           _stream_advance(ph[1][2], ph[1][0], ph[1][1], axl, ayl,
                           cxn, my_xn, m2xn, m2y_xn, mxy_xn),
           _stream_advance(ph[2][2], ph[2][0], ph[2][1], axl, ayl,
                           mx_yp, cyp, m2x_yp, m2yp, mxy_yp),
           _stream_advance(ph[3][2], ph[3][0], ph[3][1], axl, ayl,
                           mx_yn, cyn, m2x_yn, m2yn, mxy_yn)]

    wa = torch.where(alive, w, 0.0)
    wd = (wa * wxp, wa * wxn, wa * wyp, wa * wyn)

    yield wd
    # adv[d] = (vox, voy, m2xo, m2yo, mxyo) of stream d, in push order.
    for q in range(5):
        yield tuple(wd[d] * adv[d][q] for d in range(4))
    for pay in (pay_fx, pay_fy, pay_fx2, pay_fy2):
        yield tuple(None if p is None else wa * p for p in pay)

    # Carried-channel deposits: per-stream per-class attenuated weights
    # (alive-masked), folded once per class and reused across channels;
    # the +-1e30 clip after the carried*factor product restores the
    # carried ceiling (growth factors can saturate to inf, never NaN).
    classes = getattr(rules, "classes", None)
    if classes is None:
        classes = tuple(range(len(carried)))
    nk = (max(classes) + 1) if len(classes) else 0
    wz = [torch.where(alive, f, 0.0) for f in (wxp, wxn, wyp, wyn)]
    fw = [tuple(wz[d] * ph[d][3][k] for d in range(4)) for k in range(nk)]
    for c, k in zip(carried, classes):
        yield tuple(torch.clamp(c * f, -1e30, 1e30) for f in fw[k])

def as_stack(x):
    """(S, W, H) float32 tensor from a channel sequence or a stack."""
    if isinstance(x, (list, tuple)):
        return torch.stack([torch.as_tensor(c, dtype=torch.float32)
                            for c in x], dim=0)
    return torch.as_tensor(x)


def n_deposits(S, closure=None):
    """Deposit-channel count C of an S-channel cohort state: colors x
    nodes ensembles of NSTATE moments + C carried totals."""
    cl = _check_closure(closure)
    groups = int(cl.nodes or 1) * int(cl.colors or 1)
    per, rem = divmod(S, groups)
    if rem or per <= NSTATE:
        raise ValueError(
            f"cohort state of {S} channels is not {cl.colors} colors x "
            f"{cl.nodes} nodes of NSTATE={NSTATE} moments + carried totals"
        )
    return per - NSTATE


def carried_live(ST, closure=None):
    """Per-deposit-channel live carried mass: sum over ensembles (nodes
    and colors, in order) and cells of |carried|, (C,) float32. For
    contractive rules `carried_live * rounds_remaining` bounds the
    remaining deposits; for others only live == 0 does (see
    `tail_converged`)."""
    P = NSTATE + n_deposits(ST.shape[0], closure)
    live = None
    for j in range(ST.shape[0] // P):
        s = torch.sum(torch.abs(ST[j * P + NSTATE:(j + 1) * P]), dim=(1, 2))
        live = s if live is None else live + s
    return live


def deposit_gauge(G):
    """Per-channel deposit magnitude gauge, (C,) float32."""
    return torch.sum(torch.abs(G), dim=(1, 2))


def tail_converged(live, gauge, remaining_rounds, tol, contractive=False):
    """True once the solve provably cannot add more than tol of the
    accumulated deposits. contractive=True (every transit factor <= 1):
    the live*remaining bound applies. False (the default, required for
    debris whose suspension factor can exceed 1): exit only at exactly
    zero live carried mass, which bounds the tail at zero for any
    physics ("zero" as the JAX package sees it with subnormals flushed:
    below the smallest normal float). Returns a 0-dim bool tensor on the
    inputs' device."""
    if contractive:
        # Python scalars, rounded to float32 by the ops as the JAX
        # package's float32 arrays are: no tensor from host data, so the
        # check can run inside a CUDA-graph capture.
        return torch.all(live * float(remaining_rounds) <= gauge * float(tol))
    return torch.all(live < torch.finfo(torch.float32).tiny)


def cohort_advance_reference(st0, aux, rules, iters, Llen, *, closure=None,
                             tol=0.0, G=None):
    """Plain torch solve: one zero-boundary push per round (exact, no
    blocking), on the inputs' device. Returns (advanced state, deposits).
    `tol` > 0 adds the per-round convergence exit (see carried_live). The
    deposits accumulate onto `G` when given (not written), else onto
    zeros."""
    st = as_stack(st0)
    aux = as_stack(aux)
    C = n_deposits(st.shape[0], closure)
    if G is None:
        G = torch.zeros((C,) + tuple(st.shape[1:]), dtype=st.dtype,
                        device=st.device)
    contractive = bool(getattr(rules, "contractive", False))
    for i in range(int(iters)):
        if tol and tol > 0.0 and bool(tail_converged(
                carried_live(st, closure), deposit_gauge(G),
                float(iters) - i, tol, contractive)):
            break
        st, G = cohort_round(st, G, aux, rules, Llen, closure)
    return st, G


# ---------------------------------------------------------------------------
# CUDA kernel path (csrc/cohort_round.cu)
# ---------------------------------------------------------------------------

# Kernel launches per rule set and node count (key "fluvial", "debris",
# "fluvial,nodes=4", ...; see `launch_key`), and the rounds those launches
# ran: one launch per color group and up to ROUNDS_PER_LAUNCH rounds,
# counted where the wrapper launches the kernel and nowhere else.
cohort_round_launches = {
    k if n == 1 else f"{k},nodes={n}": 0
    for k in ("fluvial", "debris") for n in (1, 2, 4)
}
cohort_rounds = dict.fromkeys(cohort_round_launches, 0)


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """The closure a cohort kernel library is built for
    (csrc/cohort_round.cu's COHORT_* defines): the round physics (offsets,
    offstep 0 off / 1 pooled / 2 per face stream, uniform streams, xmom,
    perstream) and the node rule of an N-node launch. The default
    closure's library is built without defines."""

    offsets: bool = True
    offstep: int = 1
    uniform: bool = False
    xmom: bool = False
    perstream: bool = False
    rule: str = "face"

    RULES = ("face", "sign", "cluster", "speed")

    def defines(self) -> tuple:
        """The nvcc -D flags of the variant; () for the default closure."""
        if self == KernelVariant():
            return ()
        return (f"-DCOHORT_OFFSETS={int(self.offsets)}",
                f"-DCOHORT_OFFSTEP={self.offstep}",
                f"-DCOHORT_UNIFORM={int(self.uniform)}",
                f"-DCOHORT_XMOM={int(self.xmom)}",
                f"-DCOHORT_PERSTREAM={int(self.perstream)}",
                f"-DCOHORT_RULE={self.RULES.index(self.rule)}")

    @property
    def code(self) -> int:
        """The variant packed as the library's `cohort_variant()` reports
        it."""
        return (int(self.offsets) | self.offstep << 1 | int(self.uniform) << 3
                | int(self.xmom) << 4 | int(self.perstream) << 5
                | self.RULES.index(self.rule) << 6)

    @property
    def tag(self) -> str:
        """Its part of a launch key: '' for the default closure, else the
        fields that differ ("legacy", "offstep=off", "offstep=stream",
        "uniform", "xmom", "perstream", the node rule), comma-joined."""
        bits = []
        if not self.offsets:
            bits.append("legacy")
        elif self.offstep != 1:
            bits.append("offstep=" + ("off" if self.offstep == 0
                                      else "stream"))
        bits += [n for n, on in (("uniform", self.uniform),
                                 ("xmom", self.xmom),
                                 ("perstream", self.perstream)) if on]
        if self.rule != "face":
            bits.append(self.rule)
        return ",".join(bits)


@functools.lru_cache(maxsize=None)
def kernel_variant(closure=None, nodes=1) -> KernelVariant:
    """The kernel variant that runs `closure` in a launch of `nodes` nodes
    (cached: every launch asks). Raises ValueError where `_check_closure`
    does for that node count."""
    cl = _check_closure(dataclasses.replace(closure or ENV_CLOSURE,
                                            nodes=nodes, colors=1))
    offstep = 0
    if cl.offsets and cl.offstep:
        offstep = 2 if cl.offstep == "stream" else 1
    rule = cl.node_rule if nodes > 1 and cl.node_rule in (
        "sign", "cluster", "speed") else "face"
    return KernelVariant(bool(cl.offsets), offstep, cl.vdist == "uniform",
                         bool(cl.xmom), bool(cl.perstream), rule)


def launch_key(kind, nodes=1, variant=""):
    """The `cohort_round_launches` key of a rule kind, node count and
    variant tag (`KernelVariant.tag`): "fluvial", "debris,nodes=4",
    "fluvial,legacy", "fluvial,nodes=4,sign", ..."""
    key = kind if nodes == 1 else f"{kind},nodes={nodes}"
    return f"{key},{variant}" if variant else key


_RULE_KINDS = {"fluvial": 0, "debris": 1}

# Launch geometry, mirrored from csrc/cohort_round.cu (K1, RX1, RY1, XG;
# BXN, BYN, CLN), which refuses any other: the one-node kernel's block
# (rows along x, columns along y, its ring included), ring, which is also
# the most rounds one launch runs, and channels per exchange step; the
# N-node kernel's block and cluster (blocks stacked along x).
ROUNDS_PER_LAUNCH = 2
ONE_NODE_BLOCK = (24, 32)
EXCHANGE_CHANNELS = 4
NODES_BLOCK = (8, 32)
NODES_CLUSTER = 4

# Shared memory a block may use on the H100 (227 KB).
MAX_SHARED_BYTES = 232_448


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """One launch of the cohort kernel: block (x = columns along y, y =
    rows along x) and grid in CUDA's order, the recomputed ring, blocks
    per cluster along x, rounds and dynamic shared memory bytes a block."""

    block: tuple
    grid: tuple
    ring: int
    cluster: int
    rounds: int
    smem: int


def kernel_geometry(C, nodes, W, H, rounds=1, rule="face") -> KernelGeometry:
    """The launch geometry of `rounds` rounds of a state with C carried
    channels and `nodes` nodes on a W x H grid. One node: a block owns
    its rows and columns less the ring on each side, shared memory holds
    the double-buffered 4-face exchange of EXCHANGE_CHANNELS channels, the
    aux fields and the owned deposits. N nodes (one round): a cluster owns
    its rows less one at each end, a block its columns less one at each
    side, and shared memory holds the face sums of the NSTATE + C channels
    (4 a channel, 8 for node_rule "sign": each face split by target
    quadrant), two node states (the asynchronous copies' landing slots)
    and the owned deposits."""
    if nodes == 1:
        if not 1 <= rounds <= ROUNDS_PER_LAUNCH:
            raise ValueError(f"a one-node launch runs 1..{ROUNDS_PER_LAUNCH}"
                             f" rounds, got {rounds}")
        (rows, cols), ring, cluster = ONE_NODE_BLOCK, ROUNDS_PER_LAUNCH, 1
        owned = (rows - 2 * ring, cols - 2 * ring)
        smem = 4 * (2 * 4 * EXCHANGE_CHANNELS + 4 + C) * rows * cols
    else:
        if rounds != 1:
            raise ValueError(f"an N-node launch runs 1 round, got {rounds}")
        (rows, cols), ring, cluster = NODES_BLOCK, 1, NODES_CLUSTER
        owned = (cluster * rows - 2, cols - 2)
        faces = 8 if rule == "sign" else 4
        smem = 4 * ((NSTATE + C) * (faces + 2) + C) * rows * cols
    grid = (-(-H // owned[1]), cluster * -(-W // owned[0]))
    return KernelGeometry((cols, rows), grid, ring, cluster, rounds, smem)


def launch_rounds(iters, k, every=TOL_CHECK_ROUNDS) -> list:
    """Rounds of each launch of an `iters`-round solve: at most k each,
    with a launch boundary at every multiple of `every` (where the
    adaptive exit is read)."""
    out, i = [], 0
    while i < int(iters):
        n = min(k, int(iters) - i, every - i % every)
        out.append(n)
        i += n
    return out


class _CohortParams(ctypes.Structure):
    """Scalar parameters of one launch; mirrors `CohortParams` in
    csrc/cohort_round.cu field for field."""

    _fields_ = [
        ("W", ctypes.c_int),
        ("H", ctypes.c_int),
        ("Llen", ctypes.c_float),
        ("Llen2", ctypes.c_float),
        ("r", ctypes.c_float * 8),
    ]


class _CohortGeom(ctypes.Structure):
    """A `KernelGeometry`; mirrors `CohortGeom` in csrc/cohort_round.cu."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "block_x", "block_y", "grid_x", "grid_y", "ring", "cluster",
        "rounds", "smem")]


def _kernel_params(rules, W, H, Llen):
    """The launch's parameter struct; the scalar products the JAX code
    forms in Python double precision (Llen^2, the rules' scalars) are
    formed here the same way and rounded once."""
    return _CohortParams(int(W), int(H), float(Llen), float(Llen * Llen),
                         (ctypes.c_float * 8)(*rules.kernel_scalars()))


@functools.lru_cache(maxsize=None)
def _cohort_lib(variant: KernelVariant):
    """The launch function of `variant`'s kernel library (compiled from
    csrc/ at first use; the default closure's with every other source),
    checked to be built for it."""
    from soillib_tpu_torch import _native

    lib = _native.load("cohort_round", variant.defines())
    got = lib.cohort_variant()
    if got != variant.code:
        raise RuntimeError(f"the cohort kernel library reports variant "
                           f"{got}, not {variant.code} ({variant})")
    fn = lib.cohort_rounds_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(_CohortParams),
                   ctypes.POINTER(_CohortGeom),
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cohort_rounds_cuda(st, aux, G, rules, Llen, rounds=1, out=None,
                       nodes=1, closure=None, done=None):
    """`rounds` cohort rounds of one color group in ONE launch of the
    Hopper kernel built for `closure` (None -> the env default; its
    `nodes` and `colors` are not read, `nodes` is): reads `st` (S, W, H)
    with S = nodes x (NSTATE + C), `aux` (4, W, H) and `G` (C, W, H),
    writes the state after the last round into `out` (allocated when
    None) and adds every round's carried arrivals into `G` in place, in
    round order. One node: 1 to ROUNDS_PER_LAUNCH rounds; `nodes` > 1 (the
    N-node mixture, routed by `closure.node_rule`): one. `done`, a 0-dim
    int32 tensor on the card or None: while it is nonzero the launch
    reads and writes nothing (the device-side adaptive exit). Returns
    `out`."""
    kind = getattr(rules, "kind", None)
    if kind not in _RULE_KINDS:
        raise NotImplementedError(
            f"the cohort kernel runs the fluvial and debris rule sets of "
            f"this package only; got rules of kind {kind!r}"
        )
    if nodes not in (1, 2, 4):
        raise ValueError(f"nodes must be 1, 2 or 4, got {nodes}")
    variant = kernel_variant(closure, nodes)
    albedo = bool(rules.albedo_on)
    C = len(rules.classes)
    S = nodes * (NSTATE + C)
    tensors = (("st", st, S), ("aux", aux, 4), ("G", G, C))
    for name, t, ch in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 3 or t.shape[0] != ch:
            raise ValueError(
                f"{name} must be ({ch}, W, H) for {kind} rules with "
                f"albedo {'on' if albedo else 'off'} and {nodes} node(s), "
                f"got {tuple(t.shape)}"
            )
    W, H = st.shape[1], st.shape[2]
    if aux.shape[1:] != st.shape[1:] or G.shape[1:] != st.shape[1:]:
        raise ValueError("st, aux and G must share one (W, H) grid")
    geo = kernel_geometry(C, nodes, W, H, int(rounds), variant.rule)
    for name, t, _ in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if out is None:
        out = torch.empty_like(st)
    elif out.shape != st.shape or not out.is_contiguous() or out is st:
        raise ValueError("out must be a distinct contiguous tensor like st")
    if done is not None and (done.dtype != torch.int32 or done.numel() != 1
                             or done.device != st.device):
        raise ValueError("done must be one int32 on the state's device")
    params = _kernel_params(rules, W, H, Llen)
    g = _CohortGeom(*geo.block, *geo.grid, geo.ring, geo.cluster,
                    geo.rounds, geo.smem)
    fn = _cohort_lib(variant)
    stream = torch.cuda.current_stream(st.device).cuda_stream
    with torch.cuda.device(st.device):
        err = fn(_RULE_KINDS[kind], int(albedo), int(nodes),
                 ctypes.byref(params), ctypes.byref(g), st.data_ptr(),
                 aux.data_ptr(), G.data_ptr(), out.data_ptr(),
                 None if done is None else done.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cohort kernel launch failed: CUDA error {err}")
    key = launch_key(kind, nodes, variant.tag)
    cohort_round_launches[key] = cohort_round_launches.get(key, 0) + 1
    cohort_rounds[key] = cohort_rounds.get(key, 0) + geo.rounds
    return out


def cohort_round_cuda(st, aux, G, rules, Llen, out=None, nodes=1,
                      closure=None):
    """One cohort round of one color group on the card (one launch of
    `cohort_rounds_cuda`). Returns `out`."""
    return cohort_rounds_cuda(st, aux, G, rules, Llen, 1, out=out,
                              nodes=nodes, closure=closure)


def cohort_advance_cuda(st, aux, rules, iters, Llen, tol=0.0, closure=None,
                        G=None):
    """`iters` cohort rounds on the card with ping-pong state buffers;
    deposits accumulate in place, onto a copy of `G` when given (the
    sharded passes carry their deposits on), else onto zeros. A one-node,
    one-color solve runs ROUNDS_PER_LAUNCH rounds per launch
    (`launch_rounds`); otherwise each round launches the kernel once per
    color group (`closure.colors`), in color order, into the same
    deposits: the order of the plain batched round. `tol` > 0 evaluates
    the adaptive exit criterion every TOL_CHECK_ROUNDS rounds, always at a
    launch boundary: read on the host (one read each), or, inside a
    CUDA-graph capture, where the host cannot read it, into a device flag
    that makes every later launch do nothing (`_advance`). Returns
    (advanced state, deposits); after a device-side exit the state is
    not the exit round's, the deposits are."""
    return _advance_cuda(st, aux, rules, iters, Llen, tol, closure, G)[:2]


def _advance_cuda(st, aux, rules, iters, Llen, tol, closure, G=None):
    """`cohort_advance_cuda`, returning (state, deposits, rounds run): with
    `tol` > 0 the rounds run stop at a TOL_CHECK_ROUNDS check; under
    capture the host cannot know where, and the rounds run are counted
    as all of them."""
    capturing = (torch.cuda.is_available()
                 and torch.cuda.is_current_stream_capturing())
    return _advance(st, aux, rules, iters, Llen, tol, closure, G,
                    cohort_rounds_cuda, capturing)


def _advance(st, aux, rules, iters, Llen, tol, closure, G, launch,
             device_exit):
    """The kernel path's schedule, with `launch` (`cohort_rounds_cuda`'s
    signature) for the launches. `device_exit` False: the exit criterion
    is read on the host at each check, and the loop breaks. True: it is
    OR-ed into a device flag (torch ops only) that every launch gets as
    `done`; the launches after the check that sets it do nothing, so
    the deposits stop at the same check and are the same bits."""
    cl = _check_closure(closure)
    st = as_stack(st).contiguous()
    aux = as_stack(aux).contiguous()
    C = n_deposits(st.shape[0], cl)
    ncol, nnodes = int(cl.colors or 1), int(cl.nodes or 1)
    P = st.shape[0] // ncol
    if G is None:
        G = torch.zeros((C,) + tuple(st.shape[1:]), dtype=torch.float32,
                        device=st.device)
    else:
        G = G.contiguous().clone()
    contractive = bool(getattr(rules, "contractive", False))
    k = ROUNDS_PER_LAUNCH if ncol == 1 and nnodes == 1 else 1
    adaptive = bool(tol) and tol > 0.0
    done = passed = None
    if adaptive and device_exit:
        done = torch.zeros((), dtype=torch.int32, device=st.device)
        passed = torch.zeros((), dtype=torch.int32, device=st.device)
    # Ping-pong between two fresh buffers; the caller's state is only read.
    bufs = [torch.empty_like(st), None]
    i = 0
    for n, rounds in enumerate(launch_rounds(iters, k)):
        if adaptive and i % TOL_CHECK_ROUNDS == 0:
            converged = tail_converged(carried_live(st, cl), deposit_gauge(G),
                                       float(iters) - i, tol, contractive)
            if done is None:
                if bool(converged):
                    break
            else:
                done.bitwise_or_(converged)
                passed.add_(1 - done)
        if bufs[n % 2] is None:
            bufs[n % 2] = torch.empty_like(st)
        out = bufs[n % 2]
        for j in range(ncol):
            g = slice(j * P, (j + 1) * P)
            launch(st[g], aux, G, rules, Llen, rounds, out=out[g],
                   nodes=nnodes, closure=cl,
                   **({} if done is None else {"done": done}))
        st = out
        i += rounds
    if passed is not None:
        _count_exit(passed, rules, iters, k, ncol, nnodes, cl)
    return st, G, i


def _count_exit(passed, rules, iters, k, ncol, nnodes, cl):
    """The launch counters of a device-side exit: the rounds before it
    are the checks passed times TOL_CHECK_ROUNDS (at most `iters`), in
    ceil(rounds / k) launches a color group; reported to the captured
    step in place of the launches enqueued."""
    key = launch_key(rules.kind, nnodes, kernel_variant(cl, nnodes).tag)
    rounds = torch.clamp(passed * TOL_CHECK_ROUNDS, max=int(iters))
    launches = torch.div(rounds + (k - 1), k, rounding_mode="floor")
    count_on_device(cohort_round_launches, key,
                    ncol * len(launch_rounds(iters, k)), launches * ncol)
    count_on_device(cohort_rounds, key, ncol * int(iters), rounds * ncol)


def _plain_rounds(st, G, aux, rules, Llen, closure, n):
    for _ in range(n):
        st, G = cohort_round(st, G, aux, rules, Llen, closure)
    return st, G


def _cohort_checkpointed(st0, aux, rules, iters, Llen, closure):
    """Deposits of `iters` plain rounds from G = 0 (`cohort_advance_reference`
    at tol = 0), rematerialized per HALO_K-round block: reverse mode keeps
    only the block-boundary (state, deposits) and recomputes each block's
    rounds in the backward pass."""
    C = n_deposits(st0.shape[0], closure)
    st = st0
    G = torch.zeros((C,) + tuple(st0.shape[1:]), dtype=st0.dtype,
                    device=st0.device)
    n_full, rem = divmod(int(iters), HALO_K)
    for n in [HALO_K] * n_full + ([rem] if rem else []):
        st, G = checkpoint(
            lambda s_, g_, n=n: _plain_rounds(s_, g_, aux, rules, Llen,
                                              closure, n),
            st, G, use_reentrant=False)
    return G


class DiffableCohort(torch.autograd.Function):
    """The cohort solve through the kernels (`cohort_advance_cuda`) with a
    plain reverse pass: the backward replays exactly the rounds the
    forward ran (with `tol` > 0 the kernel path stops at a
    TOL_CHECK_ROUNDS check, not at the plain exit round) as plain
    `cohort_round`s at tol = 0, checkpointed per HALO_K-round block.
    Cotangents for the state and aux; `rules`, `iters`, `Llen`, `closure`
    and `tol` get None."""

    @staticmethod
    def forward(ctx, st0, aux, rules, iters, Llen, closure, tol):
        _, G, ran = _advance_cuda(st0, aux, rules, iters, Llen, tol, closure)
        ctx.args = (rules, ran, Llen, closure)
        ctx.save_for_backward(st0, aux)
        return G

    @staticmethod
    def backward(ctx, ct):
        rules, ran, Llen, closure = ctx.args
        if ran == 0:
            return (None,) * 7
        grads = _vjp_checkpointed(
            ctx.saved_tensors, ct,
            lambda s, a: _cohort_checkpointed(s, a, rules, ran, Llen,
                                              closure))
        return (*grads, None, None, None, None, None)


def run_cohort(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
    """Device-dispatched single-device cohort solve -> deposits: CUDA
    tensors launch the kernel (reverse mode through DiffableCohort), CPU
    tensors run the plain rounds."""
    st = as_stack(st0)
    if st.device.type == "cuda":
        return DiffableCohort.apply(st, as_stack(aux), rules, int(iters),
                                    Llen, closure, tol)
    if st.device.type != "cpu":
        raise ValueError(f"no cohort solve for device {st.device}")
    return cohort_advance_reference(st, aux, rules, int(iters), Llen,
                                    closure=closure, tol=tol)[1]
