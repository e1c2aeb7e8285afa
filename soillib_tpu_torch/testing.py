"""Seeded problems shared by the port's tests and `chip_smoke.py`: the
closures of the JAX package's gradient tests by name, the JAX kernel
tests' seeded cohort state, its split over a closure's nodes, the band
problem of the gradient tests, for the particle estimators a seeded
mid-run erosion state, births injected in place of the generator's and
the inputs of their trajectory loop, and an LZW encoder for the decoders. Imports numpy and torch only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from soillib_tpu_torch.ops.cohort import NSTATE, CohortClosure

# The closures the JAX package's reverse-mode sweep drives
# (tests/test_grad_closures.py), by name.
CLOSURES = {
    "legacy": CohortClosure(offsets=False, offstep=False),
    "offstep-off": CohortClosure(offstep=False),
    "default": CohortClosure(),
    "stream": CohortClosure(offstep="stream"),
    "all-on": CohortClosure(vdist="uniform", xmom=True, perstream=True),
    "nodes2": CohortClosure(nodes=2),
    "nodes4": CohortClosure(nodes=4),
    "sign": CohortClosure(nodes=4, node_rule="sign"),
    "cluster": CohortClosure(nodes=4, node_rule="cluster"),
    "speed": CohortClosure(nodes=2, node_rule="speed"),
}

# Those that run another build of the cohort kernel than the default
# closure's (ops/cohort.py `KernelVariant`).
VARIANTS = ("legacy", "offstep-off", "stream", "all-on", "sign", "cluster",
            "speed")


def cohort_arrays(kind, albedo, W=72, H=60, seed=0, mass_scale=1.0,
                  aux3_scale=1.0):
    """Seeded cohort state (S, W, H) and aux (4, W, H), float32 numpy: the
    JAX kernel tests' recipe (tests/test_sweep.py `_cohort_problem`)."""
    rng = np.random.default_rng(seed)
    C = (7 if albedo else 4) if kind == "fluvial" else (6 if albedo else 3)
    w0 = np.abs(rng.normal(size=(W, H))) + 0.5
    sp = rng.normal(size=(2, W, H)) * 3.0
    carried = np.abs(rng.normal(size=(C, W, H)))
    carried[0] *= mass_scale
    accel = rng.normal(size=(2, W, H))
    if kind == "fluvial":
        aux3 = -np.abs(rng.normal(size=(W, H))) * aux3_scale  # decay rate
    else:
        aux3 = 0.5 * rng.normal(size=(W, H))                  # excess slope
    st = np.concatenate([np.stack([
        w0, w0 * sp[0], w0 * sp[1], w0 * sp[0] ** 2, w0 * sp[1] ** 2,
        w0 * sp[0] * sp[1], w0 * 0.5, w0 * 0.5, w0 / 3.0, w0 / 3.0]),
        carried]).astype(np.float32)
    aux = np.concatenate([accel, np.ones((1, W, H)), aux3[None]]).astype(
        np.float32)
    return st, aux


def split_nodes(st, closure):
    """A one-ensemble state tensor (S, W, H) split over `closure`'s nodes as
    tests/test_sweep.py seeds the JAX kernel's node tests: by entry face
    for node_rule "face", by velocity sign quadrant for "sign" and
    "cluster", and all of it in the fast node (the slow one empty) for
    "speed"."""
    if closure.nodes == 1:
        return st
    vx, vy = st[1] / st[0], st[2] / st[0]
    isx = vx.abs() >= vy.abs()
    if closure.node_rule == "speed":
        masks = [torch.ones_like(vx), torch.zeros_like(vx)]
    elif closure.node_rule in ("sign", "cluster"):
        masks = [(vx >= 0) & (vy >= 0), (vx >= 0) & (vy < 0),
                 (vx < 0) & (vy >= 0), (vx < 0) & (vy < 0)]
    elif closure.nodes == 2:
        masks = [isx, ~isx]
    else:
        masks = [isx & (vx >= 0), isx & (vx < 0), ~isx & (vy >= 0),
                 ~isx & (vy < 0)]
    return torch.cat([st * m.to(st.dtype)[None] for m in masks]).contiguous()


def band_problem(closure, v):
    """tests/test_grad_closures.py's state and aux on v's grid and device:
    weight on a diagonal band, the rest EXACT zeros (still cells, dead
    streams, zero moments); for N nodes the other nodes are exact-zero
    ensembles. The velocity field v enters the state."""
    W, H = v.shape
    z = torch.zeros((W, H), device=v.device)
    o = torch.ones((W, H), device=v.device)
    ix = (torch.arange(W, device=v.device)[:, None]
          - torch.arange(H, device=v.device)[None, :])
    wgt = torch.where(ix.abs() <= 1, 1.0, 0.0)
    st = [wgt, wgt * v, 0.3 * wgt * v, wgt * v * v, z, z,
          0.5 * wgt, 0.5 * wgt, wgt / 3.0, wgt / 3.0,
          wgt, 0.1 * wgt, wgt * v, z, 0.2 * wgt, 0.2 * wgt, 0.2 * wgt]
    assert len(st) == NSTATE + 7
    st = st + [z] * ((closure.nodes - 1) * len(st))
    aux = [0.05 * o, -0.02 * o, o, -0.1 * o]
    return torch.stack(st), torch.stack(aux)


def particle_state_fields(W, H, seed):
    """A seeded mid-run erosion state as float32 numpy arrays keyed by the
    ErosionState field names: rough terrain (slopes on both sides of the
    landslide threshold), water, sediment, debris, momentum, albedos."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    def u(*s):
        return rng.uniform(size=s).astype(np.float32)

    bed = 2.0 + 0.05 * np.cumsum(np.cumsum(f(W, H), axis=0), axis=1)
    return dict(
        layers=np.stack([bed, np.abs(f(W, H)) * 0.01]),
        rainfall=np.ones((W, H), np.float32),
        uplift=u(W, H),
        discharge=np.abs(f(W, H)),
        mass=np.abs(f(W, H)) * 1e-6,
        momentum=f(2, W, H) * 0.1,
        debris=np.abs(f(W, H)) * 1e-3,
        debris_momentum=f(2, W, H) * 0.1,
        albedo_bedrock=u(3, W, H),
        albedo_surface=u(3, W, H),
        albedo_fluvial=u(3, W, H),
        albedo_debris=u(3, W, H),
    )


def birth_draws(n, count, seed):
    """`count` seeded (ux, uy) pairs of n float32 uniforms in [0, 1)."""
    rng = np.random.default_rng(seed)
    return [(rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32))
            for _ in range(count)]


@contextlib.contextmanager
def injected_births(draws):
    """While active, the particle estimators take their births' uniforms
    from `draws` ((ux, uy) numpy pairs, one pair a solve, in order) on the
    device they ask for, instead of from their generator. Yields the list
    of pairs not taken yet."""
    from soillib_tpu_torch.ops import transport

    queue = list(draws)
    real = transport._birth_uniforms

    def births(n, generator, device):
        ux, uy = queue.pop(0)
        if len(ux) != n:
            raise ValueError(f"injected {len(ux)} births, the solve asks "
                             f"for {n}")
        return (torch.from_numpy(ux).to(device),
                torch.from_numpy(uy).to(device))

    transport._birth_uniforms = births
    try:
        yield queue
    finally:
        transport._birth_uniforms = real


def flagship_particle_step(fields, device, maxage, draws):
    """One coupled step of the reference flagship's configuration with
    transportMethod="particles" (examples/erosion.py `make_param`:
    nSamples 8192; a 20 km world) and `maxage`, from `fields`
    (`particle_state_fields`) on `device`, the births' uniforms taken
    from `draws` (one pair a transport)."""
    from soillib_tpu_torch.convert import state_from_numpy
    from soillib_tpu_torch.examples.erosion import make_param
    from soillib_tpu_torch.models.simulation import erode_step

    p = make_param()
    p.transportMethod, p.maxage = "particles", maxage
    W, H = fields["discharge"].shape
    with injected_births(draws) as left:
        out = erode_step(state_from_numpy(fields, device),
                         (20.0 / W, 20.0 / H, 4.0), p)
    if left:
        raise AssertionError(f"{len(left)} injected births not taken")
    return out


def particle_round_inputs(kind, fields, scale, p, device, draw):
    """What `_fluvial_particles` (kind "fluvial") or `_debris_particles`
    ("debris") hands its trajectory loop, from the state `fields`
    (`particle_state_fields`) on `device` with parameters `p`
    (p.nSamples particles, p.maxage - 1 rounds), the births' uniforms
    taken from `draw` (one (ux, uy) pair of `birth_draws`): the keyword
    arguments of models/erosion.py `_particle_rounds`."""
    import math

    from soillib_tpu_torch.core.halo import NO_HALO
    from soillib_tpu_torch.models import erosion

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in fields.items()}
    W, H = t["discharge"].shape
    sx, sy = float(scale[0]), float(scale[1])
    N = int(p.nSamples)
    Q = sx * sy * W * H / N
    mom = t["momentum" if kind == "fluvial" else "debris_momentum"]
    flds = erosion._particle_fields(t["layers"], mom, t["albedo_surface"],
                                    scale, p, NO_HALO)
    with injected_births([draw]):
        px, py, ind = erosion._particle_births(W, H, N, None, device)
    if kind == "fluvial":
        spx, spy, alive, src, advance = erosion._fluvial_start(
            p, scale, Q, flds, t["rainfall"].reshape(-1),
            t["discharge"].reshape(-1), ind)
    else:
        spx, spy, alive, src, advance = erosion._debris_start(
            p, scale, Q, flds, ind)
    att = torch.ones((max(advance.sel) + 1, N), dtype=torch.float32,
                     device=device)
    return dict(W=W, H=H, rounds=max(int(p.maxage) - 1, 0), px=px, py=py,
                ind=ind, spx=spx, spy=spy, alive=alive, src=src, att=att,
                Llen=math.sqrt(sx * sx + sy * sy), advance=advance)


def lzw_encode(data: bytes) -> bytes:
    """Minimal TIFF-variant LZW encoder (MSB-first, early change), as
    the JAX package's tests/test_native.py has it: a test oracle only
    (the port's codec writes uncompressed TIFFs)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitbuf = bitcnt = 0

    def put(code, width):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8

    table = {bytes([i]): i for i in range(256)}
    nxt, width = 258, 9
    put(CLEAR, width)
    w = b""
    for ch in data:
        c = bytes([ch])
        if w + c in table:
            w = w + c
            continue
        put(table[w], width)
        table[w + c] = nxt
        nxt += 1
        if nxt == (1 << width) and width < 12:
            width += 1
        if nxt >= 4094:
            put(CLEAR, width)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = c
    if w:
        put(table[w], width)
    put(EOI, width)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)
