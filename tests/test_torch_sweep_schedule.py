"""The transport sweep kernel path's plain parts, on the CPU: how
`transport_advance_cuda` splits a solve into launches
(`sweep_launch_rounds`), the launch geometry the wrapper computes and hands
to the kernel (`sweep_geometry`, mirrored from csrc/transport_sweep.cu),
what the wrapper refuses, and a plain torch emulation of the kernel's
blocked schedule (windows with a SWEEP_K-cell ring, the light cone, only
owned cells kept) that must reproduce the plain rounds bitwise. The kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from soillib_tpu_torch.ops import sweep

torch.set_num_threads(1)

K = sweep.SWEEP_K
SOURCE = (Path(__file__).resolve().parent.parent / "soillib_tpu_torch" /
          "csrc" / "transport_sweep.cu")
NAN = float("nan")


def sweep_problem(C, W, H, seed=0):
    """Seeded (G0, E, att, vx, vy) on the CPU: a non-zero G0, both signs
    of both direction components, a few dead cells (zero direction)."""
    rng = np.random.default_rng(seed)
    G0 = rng.uniform(0.0, 2.0, size=(C, W, H))
    E = np.abs(rng.normal(size=(C, W, H)))
    att = rng.uniform(0.3, 0.99, size=(C, W, H))
    d = rng.normal(size=(2, W, H))
    d[:, ::9, ::7] = 0.0
    n = np.maximum(np.sqrt(d[0] ** 2 + d[1] ** 2), 1e-30)
    return [torch.from_numpy(a.astype(np.float32))
            for a in (G0, E, att, d[0] / n, d[1] / n)]


def _window(a, x0, y0, rows, cols, fill):
    """The rows x cols window of a (W, H) field at (x0, y0); `fill`
    outside the field."""
    W, H = a.shape
    out = torch.full((rows, cols), fill, dtype=a.dtype)
    xa, xb = max(0, x0), min(W, x0 + rows)
    ya, yb = max(0, y0), min(H, y0 + cols)
    if xa < xb and ya < yb:
        out[xa - x0:xb - x0, ya - y0:yb - y0] = a[xa:xb, ya:yb]
    return out


def _shifted(s, dx, dy):
    """t[r, c] = s[r - dx, c - dy], NaN where that lies outside the window
    (a kernel thread never reads there: those cells are never updated)."""
    t = torch.full_like(s, NAN)
    R, Cc = s.shape
    t[max(0, dx):R + min(0, dx), max(0, dy):Cc + min(0, dy)] = \
        s[max(0, -dx):R - max(0, dx), max(0, -dy):Cc - max(0, dy)]
    return t


def blocked_launch(G, E, att, vx, vy, rounds, cone=0):
    """One launch of the kernel's schedule in plain torch: every tile of
    `sweep_geometry` loads its window, forms its donors' weights (+0.0 for
    a donor outside the domain), runs `rounds` rounds in the light cone
    (payloads within rounds - r of the owned tile, updates within
    rounds - 1 - r; `cone` widens or narrows both) and writes its owned
    cells. Cells inside the domain that a round does not compute hold NaN,
    so any read of one reaches the result. Payload slots outside the domain
    hold +0.0. Every cell of the result is written by exactly one tile
    (the order in which the kernel's persistent blocks walk the tiles does
    not change what a tile computes)."""
    C, W, H = E.shape
    geo = sweep.sweep_geometry(C, W, H, rounds)
    tx, ty = sweep.SWEEP_TILE
    ring = geo.ring
    rows, cols = tx + 2 * ring, sweep.SWEEP_WINDOW_COLS
    assert cols == ty + 2 * ring
    mxp, mxn, myp, myn = sweep._round_weights(vx, vy)
    out = torch.full_like(E, NAN)
    r_idx = torch.arange(rows)[:, None]
    c_idx = torch.arange(cols)[None, :]
    dx = torch.clamp(torch.maximum(ring - r_idx, r_idx - (ring + tx - 1)),
                     min=0)
    dy = torch.clamp(torch.maximum(ring - c_idx, c_idx - (ring + ty - 1)),
                     min=0)
    d = torch.maximum(dx, dy)
    for bx in range(geo.tiles[1]):
        for by in range(geo.tiles[0]):
            x0, y0 = bx * tx - ring, by * ty - ring
            xs, ys = x0 + r_idx, y0 + c_idx
            inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
            zero = torch.zeros(())
            m1 = torch.where((xs > 0) & (r_idx > 0),
                             _window(mxp, x0 - 1, y0, rows, cols, 0.0), zero)
            m2 = torch.where((xs + 1 < W) & (r_idx + 1 < rows),
                             _window(mxn, x0 + 1, y0, rows, cols, 0.0), zero)
            m3 = torch.where((ys > 0) & (c_idx > 0),
                             _window(myp, x0, y0 - 1, rows, cols, 0.0), zero)
            m4 = torch.where((ys + 1 < H) & (c_idx + 1 < cols),
                             _window(myn, x0, y0 + 1, rows, cols, 0.0), zero)
            for c in range(C):
                g = _window(G[c], x0, y0, rows, cols, 0.0)
                e = _window(E[c], x0, y0, rows, cols, 0.0)
                a = _window(att[c], x0, y0, rows, cols, 0.0)
                for r in range(rounds):
                    pc = inside & (d <= rounds - r + cone)
                    uc = inside & (d <= rounds - 1 - r + cone)
                    s = torch.where(pc, a * (e + g),
                                    torch.where(inside, NAN, 0.0))
                    new = (((_shifted(s, 1, 0) * m1
                             + _shifted(s, -1, 0) * m2)
                            + _shifted(s, 0, 1) * m3)
                           + _shifted(s, 0, -1) * m4)
                    g = torch.where(uc, new, torch.where(inside, NAN, g))
                xa, xb = bx * tx, min(W, (bx + 1) * tx)
                ya, yb = by * ty, min(H, (by + 1) * ty)
                if xa < xb and ya < yb:
                    out[c, xa:xb, ya:yb] = g[ring:ring + xb - xa,
                                             ring:ring + yb - ya]
    return out


def blocked_advance(G0, E, att, vx, vy, iters, cone=0):
    """`iters` rounds as the wrapper launches them, each launch through
    `blocked_launch`."""
    G = G0
    for n in sweep.sweep_launch_rounds(iters):
        G = blocked_launch(G, E, att, vx, vy, n, cone)
    return G


def test_rounds_per_launch_in_range():
    assert 8 <= K <= 16


@pytest.mark.parametrize("iters", [0, 1, K - 1, K, K + 1, 2 * K + 3, 37,
                                   510, 8192])
def test_launch_rounds_split(iters):
    """The launches' rounds sum to iters, none exceeds SWEEP_K, and only
    the last may run fewer."""
    split = sweep.sweep_launch_rounds(iters)
    assert sum(split) == iters
    assert all(1 <= n <= K for n in split)
    assert all(n == K for n in split[:-1])
    assert len(split) == math.ceil(iters / K)


@pytest.mark.parametrize("C", [1, 7, 13, 68])
def test_every_launch_fits_a_block(C):
    """Every geometry the wrapper can launch (any channel count, each
    rounds per launch) fits one block of the H100: 227 KB of shared
    memory and 1024 threads, and SWEEP_BLOCKS_PER_SM blocks an SM's
    shared memory; at 65536^2 the persistent grid is SWEEP_BLOCKS_PER_SM
    blocks an SM and the tile count fits the kernel's int."""
    for rounds in range(1, K + 1):
        g = sweep.sweep_geometry(C, 4096, 4096, rounds)
        assert g.smem <= sweep.MAX_SHARED_BYTES == 232_448
        assert g.block[0] * g.block[1] <= 1024
        assert g.block[0] == 32
        assert g.rounds == rounds and g.ring == K
    g = sweep.sweep_geometry(C, 65536, 65536, K, 132)
    assert g.grid == (132 * sweep.SWEEP_BLOCKS_PER_SM, 1)
    assert g.tiles[0] * g.tiles[1] < 2 ** 31
    assert g.smem * sweep.SWEEP_BLOCKS_PER_SM <= 233_472  # an SM's 228 KB


def test_geometry_mirrors_the_kernel_source():
    """The wrapper's constants are the kernel file's (which refuses any
    other geometry), and so is its shared-memory formula."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("SWEEP_K") == K
    assert const("TX") == sweep.SWEEP_TILE[0]
    assert const("WY") == sweep.SWEEP_WINDOW_COLS
    assert const("CY") == sweep.SWEEP_GROUP_COLS
    assert const("NTX") == sweep.SWEEP_THREAD_ROWS
    assert sweep.SWEEP_WINDOW_COLS == 32 * sweep.SWEEP_GROUP_COLS
    assert K % sweep.SWEEP_GROUP_COLS == 0
    assert sweep.SWEEP_TILE[1] == sweep.SWEEP_WINDOW_COLS - 2 * K
    assert (sweep.SWEEP_TILE[0] + 2 * K) % sweep.SWEEP_THREAD_ROWS == 0
    assert const("STAGED") == sweep.SWEEP_STAGED
    assert const("BPS") == sweep.SWEEP_BLOCKS_PER_SM
    assert "constexpr int SMEM = (2 + STAGED) * WIN * 4 + 8;" in src
    assert "constexpr int WIN = WX * WY;" in src
    g = sweep.sweep_geometry(1, 64, 64, 1)
    assert g.smem == (2 + sweep.SWEEP_STAGED) * (
        sweep.SWEEP_TILE[0] + 2 * K) * sweep.SWEEP_WINDOW_COLS * 4 + 8


@pytest.mark.parametrize("W,H", [(1, 1), (5, 3), (K - 1, 200), (32, 112),
                                 (33, 113), (75, 61), (4097, 33),
                                 (4096, 4096)])
def test_grid_covers_the_domain(W, H):
    """The grid's owned tiles cover W x H, with no block that owns none
    of it."""
    g = sweep.sweep_geometry(1, W, H, K)
    tx, ty = sweep.SWEEP_TILE
    assert g.tiles[0] * ty >= H > (g.tiles[0] - 1) * ty
    assert g.tiles[1] * tx >= W > (g.tiles[1] - 1) * tx
    assert g.grid == (g.tiles[0] * g.tiles[1], 1)
    for sms in (1, 132, 10 ** 6):
        p = sweep.sweep_geometry(1, W, H, K, sms)
        assert p.tiles == g.tiles
        assert p.grid == (min(sweep.SWEEP_BLOCKS_PER_SM * sms, g.grid[0]), 1)


def test_geometry_refuses_other_rounds_and_shapes():
    for rounds in (0, K + 1, -1):
        with pytest.raises(ValueError, match="rounds"):
            sweep.sweep_geometry(1, 8, 8, rounds)
    with pytest.raises(ValueError, match="no sweep"):
        sweep.sweep_geometry(0, 8, 8, 1)


def test_wrapper_refuses_before_launching():
    """CPU tensors (even of the right shapes), other types, layouts and
    shapes, rounds beyond a launch's and an `out` that is G: all refused
    before anything is built or launched."""
    G0, E, att, vx, vy = sweep_problem(2, 9, 7)
    before = (dict(sweep.sweep_launches), dict(sweep.sweep_rounds))
    with pytest.raises(ValueError, match="CUDA"):
        sweep.transport_advance_cuda(G0, E, att, vx, vy, 3)
    with pytest.raises(ValueError, match="CUDA"):
        sweep.transport_rounds_cuda(G0, E, att, vx, vy, 1,
                                    torch.empty_like(E))
    with pytest.raises(ValueError, match="float32"):
        sweep.transport_advance_cuda(G0.double(), E, att, vx, vy, 3)
    with pytest.raises(ValueError, match="contiguous 3-d"):
        sweep.transport_advance_cuda(G0.transpose(1, 2), E, att, vx, vy, 3)
    with pytest.raises(ValueError, match="share one"):
        sweep.transport_advance_cuda(G0[:1].contiguous(), E, att, vx, vy, 3)
    with pytest.raises(ValueError, match="vx and vy"):
        sweep.transport_advance_cuda(G0, E, att, vx[:8].contiguous(), vy, 3)
    with pytest.raises(ValueError, match="rounds"):
        sweep.sweep_geometry(2, 9, 7, K + 1)
    assert (sweep.sweep_launches, sweep.sweep_rounds) == before


def test_advance_splits_launches(monkeypatch):
    """`transport_advance_cuda`'s schedule with the emulated launch
    standing in for the kernel: SWEEP_K rounds a launch and one remainder,
    ping-pong buffers that never alias G, the caller's G0 untouched, and
    the result bitwise that of the plain rounds."""
    G0, E, att, vx, vy = sweep_problem(2, 20, 18, seed=5)
    keep = G0.clone()
    calls = []

    def fake(G, E_, att_, vx_, vy_, rounds, out):
        assert out.data_ptr() != G.data_ptr()
        calls.append(rounds)
        out.copy_(blocked_launch(G, E_, att_, vx_, vy_, rounds))
        return out

    monkeypatch.setattr(sweep, "_check_sweep_inputs",
                        lambda G, E_, *a: tuple(E_.shape))
    monkeypatch.setattr(sweep, "transport_rounds_cuda", fake)
    iters = 2 * K + 3
    got = sweep.transport_advance_cuda(G0, E, att, vx, vy, iters)
    assert calls == [K, K, 3]
    assert torch.equal(G0, keep)
    want = sweep.transport_advance_reference(G0, E, att, vx, vy, iters)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    calls.clear()
    got0 = sweep.transport_advance_cuda(G0, E, att, vx, vy, 0)
    assert calls == [] and torch.equal(got0, G0)
    assert got0.data_ptr() != G0.data_ptr()


@pytest.mark.parametrize("C,W,H", [(1, 75, 61), (7, 40, 250), (13, 5, 3),
                                   (2, K - 3, 130)])
@pytest.mark.parametrize("iters", [1, K - 1, K, K + 1, 2 * K + 3, 37])
def test_blocked_schedule_matches_plain_rounds_bitwise(C, W, H, iters):
    """The kernel's schedule (windows with the ring, the light cone, only
    owned cells written, +0.0 from donors outside the domain) reproduces
    `transport_advance_reference` bitwise, on ragged domains: several
    blocks each way, smaller than one tile, narrower than the ring."""
    G0, E, att, vx, vy = sweep_problem(C, W, H, seed=C + W)
    got = blocked_advance(G0, E, att, vx, vy, iters)
    want = sweep.transport_advance_reference(G0, E, att, vx, vy, iters)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_a_narrower_light_cone_is_caught():
    """The emulation can fail: with the cone one cell narrower, cells the
    owned tile needs are never computed and their NaN reaches it."""
    G0, E, att, vx, vy = sweep_problem(1, 75, 61, seed=2)
    got = blocked_advance(G0, E, att, vx, vy, K, cone=-1)
    assert bool(torch.isnan(got).any())
