"""The tile kernels' schedule (soillib_tpu_torch/csrc/tile_accumulate.cu), on
the CPU: a plain numpy emulation of how the kernels order their work, held
BITWISE against the plain full-grid fixed points `local_fp_plain` and
`trace_plain` of ops/graph_tiled.py.

Per 128^2 tile the emulation builds what the kernel builds (each cell's
in-tile receiver code, its donor mask and pending count), orders the cells
as the kernel does (the local push: level-synchronous worklists or the
last-arrival continuation, leaves first; the trace: worklists seeded with
the cells that never update, receivers first) and computes each cell ONCE
with the kernel's float32 arithmetic in its order. A tile whose in-tile
graph has a cycle, or whose dependency depth exceeds the cap, runs the
emulated Jacobi rounds instead, as the kernel's branch does. A cell
computed one step early must be caught. The kernels themselves run only on
the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from soillib_tpu_torch.core.grid import D4, D8, shifts_for
from soillib_tpu_torch.ops import graph
from soillib_tpu_torch.ops import graph_tiled as gt

torch.set_num_threads(1)

T = gt.TILE
NONE = 15
NT = 1024  # the kernel's threads a block: the continuation's walk order
SOURCE = (Path(__file__).resolve().parent.parent / "soillib_tpu_torch" /
          "csrc" / "tile_accumulate.cu")
F0 = np.float32(0.0)


def _shift(a, dx, dy, fill):
    """t[x, y] = a[x - dx, y - dy] on a tile, `fill` outside it."""
    t = np.full_like(a, fill)
    X, Y = a.shape
    t[max(0, dx):X + min(0, dx), max(0, dy):Y + min(0, dy)] = \
        a[max(0, -dx):X - max(0, dx), max(0, -dy):Y - max(0, dy)]
    return t


def _tile(a, x0, y0, fill):
    """The 128^2 tile at (x0, y0) of a (W, H) array, `fill` past the grid."""
    out = np.full((T, T), fill, dtype=a.dtype)
    part = a[x0:x0 + T, y0:y0 + T]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _tiles(W, H):
    for x0 in range(0, W, T):
        for y0 in range(0, H, T):
            yield x0, y0, min(T, W - x0), min(T, H - y0)


def _codes(slot, K, nx, ny, in_grid_receivers):
    """Receiver code per tile cell: the slot of a receiver in the tile
    (and, for the push, in the grid), else NONE."""
    code = np.full((T, T), NONE, np.int32)
    lx = np.arange(T)[:, None]
    ly = np.arange(T)[None, :]
    lim = (nx, ny) if in_grid_receivers else (T, T)
    for d, (dx, dy) in enumerate(shifts_for(D8)[:K]):
        rx, ry = lx + int(dx), ly + int(dy)
        ok = (slot == d) & (rx >= 0) & (rx < lim[0]) & (ry >= 0) & \
            (ry < lim[1])
        code = np.where(ok, d, code)
    return code


def _masks(code, K):
    """Donor mask per tile cell: bit d where the cell at cell - shift_d
    has code d."""
    m = np.zeros((T, T), np.int32)
    for d, (dx, dy) in enumerate(shifts_for(D8)[:K]):
        m |= (_shift(code, int(dx), int(dy), NONE) == d).astype(np.int32) << d
    return m


def _offsets(K):
    return [int(dx) * T + int(dy) for dx, dy in shifts_for(D8)[:K]]


def push_levels(code, mask, cells, K, early=False):
    """The level-synchronous worklists: (order, depth), order None where
    some cell never becomes ready. `early` moves the deepest cell to the
    front of the level before its own: one step early."""
    off = _offsets(K)
    cnt = {c: bin(mask.flat[c]).count("1") for c in cells}
    level = [c for c in cells if cnt[c] == 0]
    levels = []
    while level:
        levels.append(level)
        nxt = []
        for c in level:
            s = code.flat[c]
            if s != NONE:
                r = c + off[s]
                cnt[r] -= 1
                if cnt[r] == 0:
                    nxt.append(r)
        level = nxt
    if sum(map(len, levels)) != len(cells):
        return None, len(levels) - 1
    if early:
        last = levels[-1][0]
        levels[-1].remove(last)
        levels[-2].insert(0, last)
    return [c for lv in levels for c in lv], len(levels) - 1


def push_continuation(code, mask, cells, K):
    """The last-arrival continuation, one thread at a time in thread and
    cell order: each leaf walks down while it is the last arrival."""
    off = _offsets(K)
    cnt = np.array([bin(v).count("1") for v in mask.flat])
    h = np.zeros(T * T, np.int32)
    in_grid = np.zeros(T * T, bool)
    in_grid[cells] = True
    order = []
    for tid in range(NT):
        for li in range(tid, T * T, NT):
            if not in_grid[li] or mask.flat[li] != 0:
                continue
            c = li
            while True:
                order.append(c)
                h[c] = max([h[c - off[d]] + 1 for d in range(K)
                            if mask.flat[c] >> d & 1], default=0)
                s = code.flat[c]
                if s == NONE:
                    break
                r = c + off[s]
                cnt[r] -= 1
                if cnt[r] != 0:
                    break
                c = r
    depth = int(h[order].max()) if order else 0
    return (order if len(order) == len(cells) else None), depth


def _jacobi_push(src, w, mask, in_grid, K, cap):
    """The kernel's Jacobi branch on one tile: (G, rounds)."""
    G = np.zeros((T, T), np.float32)
    r = 0
    while True:
        pay = np.where(in_grid, w * (src + G), F0).astype(np.float32)
        g = np.zeros((T, T), np.float32)
        for d, (dx, dy) in enumerate(shifts_for(D8)[:K]):
            g = np.where(mask >> d & 1, g + _shift(pay, int(dx), int(dy), F0),
                         g)
        ch = bool((g.view(np.int32) != G.view(np.int32)).any())
        G, r = g, r + 1
        if not ch or r >= cap:
            return G, r


def emulate_local_fp(lslot, src, w, edge, max_iters, schedule="levels",
                     early=False):
    """The local push kernel on the CPU: (G, rounds per tile) as numpy."""
    K = len(shifts_for(edge))
    cap = gt._tile_cap(max_iters)
    lslot, src, w = (np.asarray(a) for a in (lslot, src, w))
    W, H = src.shape
    out = np.zeros((W, H), np.float32)
    rounds = []
    off = _offsets(K)
    for x0, y0, nx, ny in _tiles(W, H):
        sl = _tile(lslot, x0, y0, -1)
        s_t = _tile(src, x0, y0, F0)
        w_t = _tile(w, x0, y0, F0)
        in_grid = np.zeros((T, T), bool)
        in_grid[:nx, :ny] = True
        code = np.where(in_grid, _codes(sl, K, nx, ny, True), NONE)
        mask = np.where(in_grid, _masks(code, K), 0)
        cells = list(np.flatnonzero(in_grid))
        if schedule == "levels":
            order, depth = push_levels(code, mask, cells, K, early)
        else:
            order, depth = push_continuation(code, mask, cells, K)
        if order is not None and depth <= cap:
            val = s_t.reshape(-1).copy()
            ws = w_t.reshape(-1)
            G = np.zeros(T * T, np.float32)
            for c in order:
                g = F0
                for d in range(K):
                    if mask.flat[c] >> d & 1:
                        g = g + val[c - off[d]]
                G[c] = g
                val[c] = ws[c] * (val[c] + g)
            G = G.reshape(T, T)
        else:
            G, r = _jacobi_push(s_t, w_t, mask, in_grid, K, cap)
            depth = -r
        out[x0:x0 + nx, y0:y0 + ny] = G[:nx, :ny]
        rounds.append(depth)
    return out, np.array(rounds)


def trace_levels(code, mask, K, early=False):
    """The trace's worklists: seeds are the cells that never update and
    have donors; each final cell hands its donors to the next level.
    (order of (receiver, donor) steps, depth); order None where some
    cell is never reached. `early` computes the deepest cell before the
    level of its receiver: one step early."""
    off = _offsets(K)
    seeds = [c for c in range(T * T) if code.flat[c] == NONE and mask.flat[c]]
    steps, level, depth = [], seeds, 0
    levels = []
    while level:
        nxt = []
        lv = []
        for c in level:
            for d in range(K):
                if mask.flat[c] >> d & 1:
                    lv.append((c, c - off[d]))
                    nxt.append(c - off[d])
        if lv:
            levels.append(lv)
        level = nxt
    depth = len(levels)
    n_in = int((code != NONE).sum())
    if sum(map(len, levels)) != n_in:
        return None, depth
    if early:
        last = levels[-1][0]
        levels[-1].remove(last)
        levels[-2].insert(0, last)
    steps = [s for lv in levels for s in lv]
    return steps, depth


def _jacobi_trace(X0, D0, wt, code, K, cap):
    X, D = X0.copy(), D0.copy()
    upd = code != NONE
    r = 0
    while True:
        Xn, Dn = X.copy(), D.copy()
        for d, (dx, dy) in enumerate(shifts_for(D8)[:K]):
            sel = code == d
            Xr = _shift(X, -int(dx), -int(dy), -1)
            Dr = _shift(D, -int(dx), -int(dy), F0)
            Xn = np.where(sel, Xr, Xn)
            Dn = np.where(sel, wt * Dr, Dn).astype(np.float32)
        ch = bool(((Xn != X) | (Dn.view(np.int32) != D.view(np.int32)))[upd]
                  .any())
        X, D, r = np.where(upd, Xn, X), np.where(upd, Dn, D), r + 1
        if not ch or r >= cap:
            return X, D, r


def emulate_trace(slot, w, edge, max_iters, early=False):
    """The trace kernel on the CPU: (X, D, rounds per tile) as numpy."""
    K = len(shifts_for(edge))
    cap = gt._tile_cap(max_iters)
    slot, w = np.asarray(slot), np.asarray(w)
    W, H = slot.shape
    Xo = np.zeros((W, H), np.int32)
    Do = np.zeros((W, H), np.float32)
    rounds = []
    for x0, y0, nx, ny in _tiles(W, H):
        sl = _tile(slot, x0, y0, -1)
        wt = _tile(w, x0, y0, F0)
        code = _codes(sl, K, nx, ny, False)
        mask = _masks(code, K)
        edge_cell = (sl >= 0) & (sl < K)
        X0 = np.full((T, T), -1, np.int32)
        for d, (dx, dy) in enumerate(shifts_for(D8)[:K]):
            gx = x0 + np.arange(T)[:, None] + int(dx)
            gy = y0 + np.arange(T)[None, :] + int(dy)
            X0 = np.where((sl == d) & (code == NONE), gx * H + gy, X0)
        D0 = np.where(edge_cell, wt, F0).astype(np.float32)
        steps, depth = trace_levels(code, mask, K, early)
        if steps is not None and depth <= cap:
            X, D = X0.reshape(-1).copy(), D0.reshape(-1).copy()
            for c, i in steps:
                X[i] = X[c]
                D[i] = D[i] * D[c]
            X, D = X.reshape(T, T), D.reshape(T, T)
        else:
            X, D, r = _jacobi_trace(X0, D0, wt, code, K, cap)
            depth = -r
        Xo[x0:x0 + nx, y0:y0 + ny] = X[:nx, :ny]
        Do[x0:x0 + nx, y0:y0 + ny] = D[:nx, :ny]
        rounds.append(depth)
    return Xo, Do, np.array(rounds)


# ---------------------------------------------------------------------------
# Inputs and the plain versions
# ---------------------------------------------------------------------------


def terrain_slots(W, H, edge, seed, noise=0.3):
    """Steepest-descent slot graph of a seeded rough terrain (the card
    tests' recipe, on the CPU); less noise, longer chains."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 6, W)[:, None]
    y = np.linspace(0, 5, H)[None, :]
    h = torch.from_numpy((np.sin(x) * np.cos(y) + noise * rng.normal(
        size=(W, H))).astype(np.float32))
    return graph.graph_to_slots(graph.steepest(h, edge, device="cpu"), edge)


def serpentine_slots(W, H):
    """tests/test_torch_cuda.py's serpentine: the first tile is one path of
    128^2 cells (D4)."""
    s = np.full((W, H), 3, np.int32)
    s[-1, :] = -1
    for x in range(min(T, W)):
        if x % 2 == 0:
            s[x, :T - 1] = 2
        else:
            s[x, 1:T] = 1
        s[x, T - 1 if x % 2 == 0 else 0] = 3
    return torch.from_numpy(s)


def chain_slots(W, H, L, x=5):
    """Roots everywhere but one straight +y chain of L edges in the first
    tile (D4): dependency depth L in both kernels."""
    s = np.full((W, H), -1, np.int32)
    s[x, :L] = 2
    return torch.from_numpy(s)


def with_cycle(slot, edge):
    """The slot graph with a two-cell cycle inside the first tile: (40, 40)
    and (41, 40) point at each other; cells upstream still drain into it."""
    s = slot.clone()
    shifts = [tuple(int(v) for v in sh) for sh in shifts_for(edge)]
    s[40, 40] = shifts.index((1, 0))
    s[41, 40] = shifts.index((-1, 0))
    return s


def fields(W, H, seed, unit_w=False):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.uniform(0.5, 2.0, (W, H)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.8, 1.0, (W, H)).astype(np.float32))
    return src, (torch.ones_like(w) if unit_w else w)


def plain_tiles(slot, src, w, edge, max_iters):
    """(G, X, D) of the plain full-grid fixed points."""
    W, H = slot.shape
    lslot, cross = gt._local_slot(W, H, slot, edge)
    n = torch.arange(W * H, dtype=torch.int32).reshape(W, H)
    recv = gt._pull(n, slot, edge, 0)
    G = gt.local_fp_plain(lslot, src, w, edge, max_iters)
    X, D = gt.trace_plain(slot, cross, recv, w, edge, max_iters)
    return lslot, G.numpy(), X.numpy(), D.numpy()


def assert_bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    bad = got.view(np.int32) != want.view(np.int32)
    assert not bad.any(), f"{what}: {int(bad.sum())} cells differ"


CASES = {
    "terrain-d8-300x260": lambda: (terrain_slots(300, 260, D8, 1), D8, False),
    "terrain-d4-200x140": lambda: (terrain_slots(200, 140, D4, 2), D4, False),
    "terrain-d8-100x90": lambda: (terrain_slots(100, 90, D8, 3), D8, False),
    "smooth-d8-260x300": lambda: (terrain_slots(260, 300, D8, 5, 1e-3), D8,
                                  False),
    "serpentine-200x140": lambda: (serpentine_slots(200, 140), D4, True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("schedule", ["levels", "continuation"])
def test_schedule_matches_plain_bitwise(case, schedule):
    """Both push orders and the trace's order, each cell computed once,
    equal the plain fixed points bit for bit, and every tile finishes
    under the schedule (depth >= 0) at the default cap."""
    slot, edge, unit_w = CASES[case]()
    W, H = slot.shape
    src, w = fields(W, H, W, unit_w)
    iters = T * T
    lslot, G_p, X_p, D_p = plain_tiles(slot, src, w, edge, iters)
    G, rounds = emulate_local_fp(lslot, src, w, edge, iters, schedule)
    assert_bitwise(G, G_p, "local push")
    assert (rounds >= 0).all()
    if schedule == "levels":
        X, D, trounds = emulate_trace(slot, w, edge, iters)
        assert_bitwise(X, X_p, "trace X")
        assert_bitwise(D, D_p, "trace D")
        assert (trounds >= 0).all()
    if case.startswith("serpentine"):
        # 128^2 - 1 edges on the path: its depth in both kernels.
        assert rounds[0] == T * T - 1
        if schedule == "levels":
            assert trounds[0] == T * T - 1


@pytest.mark.parametrize("edge", [D4, D8])
def test_a_cycle_takes_the_jacobi_branch(edge):
    """A tile whose in-tile graph has a cycle never finishes under the
    schedule: it runs the Jacobi rounds under the cap, bitwise equal to
    the plain version; the other tiles keep the schedule."""
    slot = with_cycle(terrain_slots(300, 260, edge, 7), edge)
    src, w = fields(300, 260, 7)
    iters = 256
    lslot, G_p, X_p, D_p = plain_tiles(slot, src, w, edge, iters)
    for schedule in ("levels", "continuation"):
        G, rounds = emulate_local_fp(lslot, src, w, edge, iters, schedule)
        assert_bitwise(G, G_p, f"local push, {schedule}")
        assert rounds[0] < 0 and (rounds[1:] >= 0).all()
    X, D, trounds = emulate_trace(slot, w, edge, iters)
    assert_bitwise(X, X_p, "trace X")
    assert_bitwise(D, D_p, "trace D")
    assert trounds[0] < 0 and (trounds[1:] >= 0).all()


@pytest.mark.parametrize("L", [31, 32, 33])
def test_caps_below_at_and_above_the_depth(L):
    """A chain of L edges under a cap of 32 rounds (max_iters 32): the
    schedule is exact while L <= cap; at L = 33 the plain version returns
    the truncated sum of 32 rounds, which the Jacobi branch reproduces."""
    W, H = 150, 140
    slot = chain_slots(W, H, L)
    src, w = fields(W, H, L, unit_w=True)
    lslot, G_p, X_p, D_p = plain_tiles(slot, src, w, D4, 32)
    for schedule in ("levels", "continuation"):
        G, rounds = emulate_local_fp(lslot, src, w, D4, 32, schedule)
        assert_bitwise(G, G_p, f"local push, {schedule}")
        assert rounds[0] == (L if L <= 32 else -32)
    X, D, trounds = emulate_trace(slot, w, D4, 32)
    assert_bitwise(X, X_p, "trace X")
    assert_bitwise(D, D_p, "trace D")
    assert trounds[0] == (L if L <= 32 else -32)
    if L > 32:
        # The cap binds: the plain result is not the converged one.
        lslot, G_full, _, _ = plain_tiles(slot, src, w, D4, 64)
        assert not np.array_equal(G_p, G_full)


def test_a_binding_cap_on_the_serpentine():
    """max_iters 4096 on the serpentine (depth 16383): the first tile runs
    4096 Jacobi rounds, the others (depth 127 or less) the schedule."""
    slot = serpentine_slots(200, 140)
    src, w = fields(200, 140, 9, unit_w=True)
    lslot, G_p, X_p, D_p = plain_tiles(slot, src, w, D4, 4096)
    G, rounds = emulate_local_fp(lslot, src, w, D4, 4096)
    assert_bitwise(G, G_p, "local push")
    X, D, trounds = emulate_trace(slot, w, D4, 4096)
    assert_bitwise(X, X_p, "trace X")
    assert_bitwise(D, D_p, "trace D")
    assert rounds[0] == -4096 and trounds[0] == -4096
    assert (rounds[1:] >= 0).all() and (trounds[1:] >= 0).all()


def test_a_cell_one_step_early_is_caught():
    """Moving the deepest cell of a tile one level ahead (computed before
    its last donor, or before its receiver) parts from the plain version:
    the bitwise comparison sees an order that is wrong by one step."""
    slot, edge, _ = CASES["terrain-d8-100x90"]()
    src, w = fields(100, 90, 4)
    lslot, G_p, X_p, D_p = plain_tiles(slot, src, w, edge, T * T)
    G, _ = emulate_local_fp(lslot, src, w, edge, T * T, early=True)
    assert not np.array_equal(G.view(np.int32), G_p.view(np.int32))
    X, D, _ = emulate_trace(slot, w, edge, T * T, early=True)
    assert not (np.array_equal(X, X_p) and
                np.array_equal(D.view(np.int32), D_p.view(np.int32)))


def test_shared_memory_fits_a_block():
    """The kernel source's per-tile shared memory (13 B a cell for the
    push, 12 for the trace, plus the static counters) fits the H100's
    227 KB a block, and its thread count divides the tile."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = ([^;]+);", src)
                   .group(1).split("*")[0].strip(" ()size_t"))

    assert const("TILE") == T
    nt = const("NT")
    assert (T * T) % nt == 0 and T * T // nt <= 64
    for name, per_cell in (("PUSH_SMEM", 13), ("TRACE_SMEM", 12)):
        assert const(name) == per_cell
        assert per_cell * T * T + 5 * 4 <= 232_448
