"""The Monte-Carlo particle estimators block-decomposed, with particle
migration between neighbouring ranks (counterpart of
`soillib_tpu/parallel/particles.py`).

* Births are drawn globally: every rank draws the same uniforms from its
  own generator seeded alike (`ops.transport._birth_uniforms`, so tests
  can inject them), then keeps the particles that fall inside its
  rectangle. The particle set is that of the single-device estimator for
  any mesh shape, and a 1 x 1 mesh reproduces it bitwise on the CPU.
  Blocks of a larger mesh agree statistically: a particle's deposit cell
  is floor(pos), discontinuous in position, and the order of the deposits
  into a cell differs from the single-device scatter.
* A particle moves at most sqrt(2) cells a round (the DDA step,
  path.cu:104-139), so migration only targets the 4 neighbours; corners
  resolve in two axis hops, x then y, as the halo does. Each round and
  axis, the particles leaving across either face are compacted into
  fixed-capacity buffers (one a direction, static shapes: a cumulative
  sum and a scatter, no sort and no host read), both directions are sent
  in one `batch_isend_irecv`, and the arrivals take the receiver's dead
  slots. A particle that finds no room in a buffer or no free slot dies
  and is counted; the estimators return the count summed over the mesh
  (`dropped`), so callers can assert 0 or run again with more `slack`.
* A particle crossing the global edge goes to no one: it dies where the
  single-device estimator's in-bounds test kills it, before depositing.

The estimators are plain torch on either device (no TPU kernel computes
them in the JAX package either); the flux is cell-major (cells, C) with
one row a particle in the scatter, as in the single-device estimators.
"""

from __future__ import annotations

import math

import torch

from soillib_tpu_torch.core.device import device_constant
from soillib_tpu_torch.core.grid import check_channel_first
from soillib_tpu_torch.models.erosion import (
    _EPS,
    _debris_start,
    _fluvial_start,
    _particle_births,
    _particle_fields,
)
from soillib_tpu_torch.ops import transport
from soillib_tpu_torch.ops.noise import _div
from soillib_tpu_torch.ops.transport import _f32, _stepsize_xy
from soillib_tpu_torch.parallel.halo import ShardHalo, post_shift


class _Geometry:
    """The global grid (W, H) and this rank's block (x0, y0, bw, bh)."""

    def __init__(self, mesh, bw, bh):
        self.mesh = mesh
        self.bw, self.bh = int(bw), int(bh)
        self.x0, self.y0 = mesh.coord[0] * self.bw, mesh.coord[1] * self.bh
        self.W, self.H = self.bw * mesh.shape[0], self.bh * mesh.shape[1]
        self.bx, self.by = _f32(self.W - 1e-3), _f32(self.H - 1e-3)
        self.lx = (float(self.x0), _f32(self.x0 + self.bw - 1e-3))
        self.ly = (float(self.y0), _f32(self.y0 + self.bh - 1e-3))

    def mine(self, px, py):
        return ((px >= self.x0) & (px < self.x0 + self.bw)
                & (py >= self.y0) & (py < self.y0 + self.bh))

    def local(self, px, py):
        """Block-local flat cell of positions clamped into the block."""
        cx = torch.clamp(px, *self.lx).to(torch.int64) - self.x0
        cy = torch.clamp(py, *self.ly).to(torch.int64) - self.y0
        return cx * self.bh + cy

    def enter(self, px, py, ind, alive):
        """The rounds' common head: the in-bounds test, then the cell a
        live particle entered (`ind`, global, updated first) and the
        block-local cell of every particle. Returns (alive, entered, ind,
        local cell)."""
        inb = (px >= 0) & (py >= 0) & (px < self.W) & (py < self.H)
        alive = alive & inb
        nind = (torch.clamp(px, 0.0, self.bx).to(torch.int64) * self.H
                + torch.clamp(py, 0.0, self.by).to(torch.int64))
        entered = alive & (nind != ind)
        ind = torch.where(entered, nind, ind)
        return alive, entered, ind, self.local(px, py)


def _compact(mask, cap):
    """Stable compaction of the True entries of `mask` into `cap` slots:
    (indices, valid, overflow). indices[i] is the i-th True entry for
    valid[i], 0 otherwise; overflow counts the True entries past cap."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    count = pos[-1] + 1 if n else torch.zeros((), dtype=torch.int64)
    target = torch.where(mask & (pos < cap), pos, cap)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, target, torch.arange(n, device=mask.device))
    valid = torch.arange(cap, device=mask.device) < count
    return idx[:cap] * valid, valid, torch.clamp(count - cap, min=0)


def _pack(R, ind, valid):
    """One float32 message: valid flag, the record rows, the global cell
    as int32 bits (global ids are int32, see parallel/graph.py)."""
    return torch.cat([valid.to(torch.float32)[None], R,
                      ind.to(torch.int32).view(torch.float32)[None]])


def _merge(R, ind, alive, pack):
    """Seat the valid records of `pack` in the dead slots of (R, ind,
    alive), in slot order. Returns (R, ind, alive, dropped): dropped =
    arrivals that found no free slot."""
    cap = pack.shape[1]
    M = R.shape[1]
    valid = pack[0] > 0.5
    slots, free, _ = _compact(~alive, cap)
    ok = valid & free
    target = torch.where(ok, slots, M)  # column M is a dump
    R = torch.cat([R, R[:, :1]], dim=1).index_copy(1, target, pack[1:-1])
    ind = torch.cat([ind, ind[:1]]).index_copy(
        0, target, pack[-1].view(torch.int32).to(torch.int64))
    seat = torch.zeros(M + 1, dtype=torch.bool, device=alive.device)
    seat[target] = ok
    return (R[:, :M], ind[:M], alive | seat[:M],
            valid.sum() - ok.sum())


def _migrate(geom, R, ind, alive, cap):
    """Move the live records that left the block to the neighbours, x
    first, then y (rows 0 and 1 of R are x and y). Returns (R, ind,
    alive, dropped)."""
    mesh = geom.mesh
    dropped = torch.zeros((), dtype=torch.int64, device=R.device)
    for axis, lo, n in ((0, geom.x0, geom.bw), (1, geom.y0, geom.bh)):
        coord = R[axis]
        leave = {-1: alive & (coord < lo), +1: alive & (coord >= lo + n)}
        alive = alive & ~leave[-1] & ~leave[+1]
        packs = {}
        for s in (-1, +1):
            if mesh.neighbor(axis, s) is None:
                # The global edge: the leavers die, as the in-bounds test
                # would kill them.
                packs[s] = None
                continue
            idx, valid, over = _compact(leave[s], cap)
            packs[s] = _pack(R[:, idx], ind[idx], valid)
            dropped = dropped + over
        if packs[-1] is None and packs[+1] is None:
            continue
        like = packs[-1] if packs[-1] is not None else packs[+1]
        arrived = post_shift(mesh, axis,
                             like if packs[-1] is None else packs[-1],
                             like if packs[+1] is None else packs[+1]).wait()
        for pack in arrived:
            if pack is not None:
                R, ind, alive, d = _merge(R, ind, alive, pack)
                dropped = dropped + d
    return R, ind, alive, dropped


def _capacity(N, n_blocks, bw, bh, slack):
    """(slots a rank, records a migration buffer), as the JAX package
    sizes them."""
    M = int(math.ceil(N / n_blocks * slack)) + 64
    return M, max(64, int(4 * M / min(bw, bh)) + 16)


def _seat_births(geom, px, py, M):
    """The births inside this rank's block, compacted into M slots:
    (x, y, global cell, valid, overflow)."""
    idx, valid, over = _compact(geom.mine(px, py), M)
    px, py = px[idx], py[idx]
    ind = px.to(torch.int64) * geom.H + py.to(torch.int64)
    return px, py, ind, valid, over


def _bilinear_global(flow_pad, px, py, geom):
    """`ops.transport.bilinear_gather` (global far-edge clamp,
    sample.hpp:155-186) evaluated on a 1-ring-padded (bw+2, bh+2, 2)
    block; a live position lies inside the block (after migration). The
    arithmetic is the single-device gather's; out of [0, W-1] x [0, H-1]
    the sample is NaN."""
    W, H = geom.W, geom.H
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    wx = px - x0.to(px.dtype)
    wy = py - y0.to(py.dtype)
    wx = torch.where(px + 1.0 > W - 1.0, 0.0, wx)
    wy = torch.where(py + 1.0 > H - 1.0, 0.0, wy)

    def lx(i):
        return torch.clamp(torch.clamp(i, 0, W - 1) - geom.x0 + 1, 0,
                           geom.bw + 1)

    def ly(i):
        return torch.clamp(torch.clamp(i, 0, H - 1) - geom.y0 + 1, 0,
                           geom.bh + 1)

    lx0, lx1, ly0, ly1 = lx(x0), lx(x0 + 1), ly(y0), ly(y0 + 1)
    oob = (px < 0) | (py < 0) | (px > W - 1.0) | (py > H - 1.0)
    wx, wy, oob = wx[..., None], wy[..., None], oob[..., None]
    v = (
        flow_pad[lx0, ly0] * (1 - wx) * (1 - wy)
        + flow_pad[lx0, ly1] * (1 - wx) * wy
        + flow_pad[lx1, ly0] * wx * (1 - wy)
        + flow_pad[lx1, ly1] * wx * wy
    )
    return torch.where(oob, math.nan, v)


def _sum_dropped(mesh, dropped):
    return int(mesh.all_reduce(dropped.reshape(1).to(torch.int64))[0])


def solve_particles_sharded(flow, source, decay, scale, count, generator,
                            mesh, maxstep=None, slack=1.5):
    """Block-decomposed `solve_uniform(method="particles")` with particle
    migration: the MC estimator of path.cu:52-139 over a mesh. `flow`
    (bw, bh, 2), `source` (bw, bh[, K]) and `decay` (bw, bh) are this
    rank's blocks; `generator` lives on the mesh's device and draws the
    global births as the single-device `_solve_particles` does. Returns
    (this rank's (bw, bh[, K]) block of the flux over `count`, particles
    dropped over the mesh)."""
    from soillib_tpu_torch.core.grid import check_channel_last

    check_channel_last("flow", flow, channels=(2,))
    bw, bh = flow.shape[0], flow.shape[1]
    if tuple(source.shape[:2]) != (bw, bh):
        raise ValueError(
            f"source spatial shape {tuple(source.shape[:2])} does not match "
            f"flow's (W, H) = {(bw, bh)}; flow must be channel-LAST (W, H, "
            f"2).")
    geom = _Geometry(mesh, bw, bh)
    dev = flow.device
    K = source.shape[2] if source.dim() == 3 else 1
    src = source.reshape(bw * bh, K)
    dec = decay.reshape(bw * bh)
    A = float(scale[0]) * float(scale[1])
    L = math.sqrt(float(scale[0]) ** 2 + float(scale[1]) ** 2)
    P = 1.0 / (A * geom.W * geom.H)
    eps = 1e-16
    N = int(count)
    M, cap = _capacity(N, mesh.size, bw, bh, slack)
    steps = int(maxstep if maxstep is not None else geom.W + geom.H)
    flow_pad = ShardHalo(mesh).pad(flow, 0.0, 1)

    ux, uy = transport._birth_uniforms(N, generator, dev)
    px, py, ind, valid, dropped = _seat_births(geom, ux * geom.W,
                                               uy * geom.H, M)
    S = _div(src[geom.local(px, py)], P).T.contiguous()  # (K, M)
    alive = valid & (torch.sqrt(torch.sum(S * S, dim=0)) >= eps)
    att = torch.ones(M, dtype=torch.float32, device=dev)
    flux = torch.zeros((bw * bh, K), dtype=torch.float32, device=dev)
    R = torch.cat([px[None], py[None], att[None], S])

    # `++step < maxstep` -> maxstep - 1 iterations (path.cu:104).
    for _ in range(max(steps - 1, 0)):
        R, ind, alive, d = _migrate(geom, R, ind, alive, cap)
        dropped = dropped + d
        px, py, att, S = R[0], R[1], R[2], R[3:]
        alive = alive & (eps < torch.abs(att))
        alive, entered, ind, li = geom.enter(px, py, ind, alive)
        flux.index_add_(0, li, torch.where(entered, S * att, 0.0).T)

        v = _bilinear_global(flow_pad, px, py, geom)
        v = torch.where(torch.isnan(v), 0.0, v)
        vx, vy = v[:, 0], v[:, 1]
        v_len = torch.sqrt(vx * vx + vy * vy)
        alive = alive & (v_len >= eps)

        v_safe = torch.clamp(v_len, min=1e-30)
        nx, ny = vx / v_safe, vy / v_safe
        stp = _stepsize_xy(px, py, nx, ny)
        dlam = stp * L / v_safe
        new_att = att * torch.exp(-dlam * dec[li])
        R = torch.cat([torch.where(alive, px + stp * nx, px)[None],
                       torch.where(alive, py + stp * ny, py)[None],
                       torch.where(alive, new_att, att)[None], S])

    G = _div(flux.reshape(bw, bh, K), float(count))
    return (G if source.dim() == 3 else G[..., 0],
            _sum_dropped(mesh, dropped))


def _erosion_rounds(geom, rounds, R, ind, alive, C, nA, cap, Llen, advance):
    """The erosion estimators' trajectory loop (models/erosion.py
    `_particle_rounds`) with migration at the head of each round. R rows:
    x, y, speed x, speed y, nA attenuations, C sources (which travel with
    their particle; `advance` gets them too). Returns (flux (C, bw*bh),
    dropped on this rank)."""
    sel = device_constant(advance.sel, torch.int64, R.device)
    flux = torch.zeros((geom.bw * geom.bh, C), dtype=torch.float32,
                       device=R.device)
    dropped = torch.zeros((), dtype=torch.int64, device=R.device)
    for _ in range(rounds):
        R, ind, alive, d = _migrate(geom, R, ind, alive, cap)
        dropped = dropped + d
        px, py, spx, spy = R[0], R[1], R[2], R[3]
        att, src = R[4:4 + nA], R[4 + nA:]
        alive, entered, ind, li = geom.enter(px, py, ind, alive)
        flux.index_add_(0, li, torch.where(entered, src * att[sel], 0.0).T)

        v_norm = torch.sqrt(spx * spx + spy * spy)
        alive = alive & (v_norm >= _EPS)
        v_safe = torch.clamp(v_norm, min=_EPS)
        ux, uy = spx / v_safe, spy / v_safe
        stp = _stepsize_xy(px, py, ux, uy)
        dL = stp * Llen
        ds = dL / v_safe
        nsx, nsy, natt = advance(li, dL, ds, v_safe, spx, spy, att, src)

        R = torch.cat([torch.where(alive, px + stp * ux, px)[None],
                       torch.where(alive, py + stp * uy, py)[None],
                       torch.where(alive, nsx, spx)[None],
                       torch.where(alive, nsy, spy)[None],
                       torch.where(alive, natt, att), src])
    return flux.T, dropped


def _sharded_estimator(start, rounds, nA, scale, p, generator, mesh, slack,
                       bw, bh, dev):
    """The erosion estimators' common frame: global births kept in this
    block, the particles' start (`start(Q, cell)`, the single-device
    estimator's own), the rounds with migration; returns (the
    channel-last (bw, bh, C) block of the flux, dropped over the mesh)."""
    geom = _Geometry(mesh, bw, bh)
    sx, sy = float(scale[0]), float(scale[1])
    N = int(p.nSamples)
    Q = sx * sy * geom.W * geom.H / N  # erosion.cu:53-54
    M, cap = _capacity(N, mesh.size, bw, bh, slack)
    gpx, gpy, _ = _particle_births(geom.W, geom.H, N, generator, dev)
    px, py, ind, valid, over = _seat_births(geom, gpx, gpy, M)
    spx, spy, alive, src, advance = start(Q, geom.local(px, py))
    att = torch.ones((nA, M), dtype=torch.float32, device=dev)
    R = torch.cat([px[None], py[None], spx[None], spy[None], att, src])
    C = src.shape[0]
    flux, dropped = _erosion_rounds(geom, rounds, R, ind, valid & alive, C,
                                    nA, cap, math.sqrt(sx * sx + sy * sy),
                                    advance)
    # flux is a channel-first view of the cell-major (bw*bh, C) flux.
    return flux.T.reshape(bw, bh, C), _sum_dropped(mesh, dropped + over)


def _check_state(layers, momentum, albedo_surface):
    """The JAX package's layout checks of the state's multichannel
    fields: channel-first, or a ValueError that names the layout."""
    check_channel_first("layers", layers, channels=(2,))
    check_channel_first("momentum", momentum, channels=(2,))
    check_channel_first("albedo_surface", albedo_surface, channels=(3,))


def fluvial_particles_sharded(layers, rainfall, discharge, momentum,
                              albedo_surface, scale, p, generator, mesh,
                              slack=1.5):
    """Block-decomposed `_fluvial_particles` (erosion.cu:29-141) with
    particle migration. The fields are this rank's blocks, the state's
    channel-first; returns (its (bw, bh, 7) channel-last block of the
    flux, as the JAX package's, dropped over the mesh). Bitwise the
    single-device estimator on a 1 x 1 mesh on the CPU."""
    _check_state(layers, momentum, albedo_surface)
    bw, bh = discharge.shape
    fields = _particle_fields(layers, momentum, albedo_surface, scale, p,
                              ShardHalo(mesh))
    rain = torch.broadcast_to(rainfall, (bw, bh)).reshape(-1)
    dis = discharge.reshape(-1)
    return _sharded_estimator(
        lambda Q, cell: _fluvial_start(p, scale, Q, fields, rain, dis, cell),
        max(int(p.maxage) - 1, 0), 3, scale, p, generator, mesh, slack, bw,
        bh, discharge.device)


def debris_particles_sharded(layers, mass, momentum, albedo_surface, scale,
                             p, generator, mesh, slack=1.5):
    """Block-decomposed `_debris_particles` (erosion.cu:245-351) with
    particle migration. Returns (this rank's (bw, bh, 6) channel-last
    block of the flux, dropped over the mesh); layouts and parity as
    `fluvial_particles_sharded`."""
    _check_state(layers, momentum, albedo_surface)
    bw, bh = mass.shape
    fields = _particle_fields(layers, momentum, albedo_surface, scale, p,
                              ShardHalo(mesh))
    return _sharded_estimator(
        lambda Q, cell: _debris_start(p, scale, Q, fields, cell),
        max(int(p.maxage) - 1, 0), 2, scale, p, generator, mesh, slack, bw,
        bh, mass.device)
