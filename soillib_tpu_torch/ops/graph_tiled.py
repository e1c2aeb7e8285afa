"""Two-level (tiled) flow accumulation — Barnes-style local/global split
(counterpart of `soillib_tpu/ops/graph_tiled.py`).

  1. LOCAL:  cut every cross-tile edge and run the one-hot push fixed
     point (graph_sweep.py) in every 128² tile; rounds are bounded by the
     longest IN-TILE path (TILE² for a serpentine path).
  2. TRACE:  per cell, pull-propagate the in-tile chain's EXIT — the entry
     cell it delivers to in the neighboring tile (X) — and the path-weight
     product (D).
  3. COARSE: cross-tile fluxes close over BOUNDARY cells only, a
     ~4N/TILE-node linear system solved by pointer doubling on compact
     arrays (plain torch: gathers and `index_add` on small arrays, as the
     JAX package leaves it to XLA).
  4. INJECT: place the converged entry fluxes on the grid and run the
     local fixed point once more to distribute them downstream in-tile.

Exact for any per-donor edge weights (accumulate_decay's my_decay
semantics included).

Phases 1, 2 and 4 are per-tile fixed points: every tile's solve is self-
contained. On CUDA tensors each is one launch of a hand-written kernel
(csrc/tile_accumulate.cu) that loads a tile into shared memory once and
computes each cell once, in dependency order (the converged value of the
fixed point is a fixed expression of the cell's donors or receiver); a
tile whose in-tile graph has a cycle, or whose dependency depth exceeds
the round cap, runs the Jacobi rounds instead, in the same launch. On CPU
tensors the plain full-grid `fixed_point` runs. Both evaluate the same
operations in the same order, so the two agree bitwise. The kernel masks
the grid's ragged edge itself, so nothing is padded to a multiple of the
tile (the JAX package's `_pad_tiles` has no counterpart). Phase 3's
`index_add` uses atomics on the card, so whole accumulations agree with
the plain solver to f32 roundoff, not bitwise.

Gradients: the kernels have no reverse mode, so `accumulate_tiled` on the
card goes through `DiffableTiledAccumulate`, whose backward is the
vector-Jacobian product of the mathematically identical pointer-doubling
accumulation (ops/graph.py `_accumulate_doubling`), the form the JAX
package differentiates off the TPU.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from soillib_tpu_torch.core.grid import D8, shifts_for
from soillib_tpu_torch.ops.graph_sweep import (
    BLOCK,
    _push_once,
    accumulate_stencil,
    fixed_point,
    roll2,
)

TILE = 128

# Kernel launches, counted where a wrapper launches its kernel and nowhere
# else: "local" = the local push fixed point (phases 1 and 4), "trace" =
# the chain-exit trace (phase 2).
tile_launches = {"local": 0, "trace": 0}


def _local_slot(W, H, slot, edge):
    """Fold the tile decomposition into the slot graph: cross-tile edges
    become -1 (roots of the LOCAL forest). Also returns the cross-edge
    mask."""
    shifts = shifts_for(edge)
    x = torch.arange(W, device=slot.device)[:, None]
    y = torch.arange(H, device=slot.device)[None, :]
    tx, ty = x // TILE, y // TILE
    cross = torch.zeros((W, H), dtype=torch.bool, device=slot.device)
    for d, (dx, dy) in enumerate(shifts):
        same = (((x + int(dx)) // TILE) == tx) & (((y + int(dy)) // TILE) == ty)
        cross = cross | ((slot == d) & ~same)
    return torch.where(cross, -1, slot), cross


def _pull(value, slot, edge, fill):
    """value[receiver(i)] per cell — gather-free (the receiver is a
    neighbor): select the d-rolled copy by the cell's own slot; `fill` at
    roots."""
    shifts = shifts_for(edge)
    out = torch.full_like(value, fill)
    for d, (dx, dy) in enumerate(shifts):
        rolled = roll2(value, -int(dx), -int(dy))
        out = torch.where(slot == d, rolled, out)
    return out


def _boundary_indices(W, H):
    """Static flat indices of all tile-boundary cells (x-major order)."""
    x = np.arange(W)[:, None]
    y = np.arange(H)[None, :]
    bx = (x % TILE == 0) | (x % TILE == TILE - 1) | (x == W - 1)
    by = (y % TILE == 0) | (y % TILE == TILE - 1) | (y == H - 1)
    mask = np.broadcast_to(bx | by, (W, H))
    return np.flatnonzero(mask.reshape(-1)).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _boundary_index_tensor(W, H, device):
    """`_boundary_indices(W, H)` as an int64 tensor on `device`, built
    once per (W, H, device): the counterpart of the JAX package's
    trace-time constant. The cache holds at most 8 shapes and only the
    device tensor; callers index with it and never write to it."""
    return torch.as_tensor(_boundary_indices(W, H), device=device).long()


def _boundary_rank(W, H, flat, fallback):
    """Compact position of global flat index `flat` within
    `_boundary_indices(W, H)` in closed form (the boundary pattern is
    periodic), in place of sort + searchsorted. `flat` < 0 maps to
    `fallback`; a flat index that is not a boundary cell's is never
    queried."""
    T = TILE
    f = torch.clamp(flat, min=0)
    x = f // H
    y = f - x * H

    def nb(z):  # boundary positions strictly before z along one axis
        return (z + T - 1) // T + z // T

    # columns per partial row over [0, H), incl. the H-1 edge column when
    # it is not already on the periodic pattern
    col_total = (H + T - 1) // T + H // T \
        + (0 if (H - 1) % T in (0, T - 1) else 1)
    # nb(y) needs no edge term: the H-1 edge column never sits strictly
    # before a queried cell's column; same for nb(x) and the W-1 row.
    full_rows = nb(x)
    full = (x % T == 0) | (x % T == T - 1) | (x == W - 1)
    rank = full_rows * H + (x - full_rows) * col_total \
        + torch.where(full, y, nb(y))
    return torch.where(flat >= 0, rank, fallback)


# ---------------------------------------------------------------------------
# Phases 1/4 and 2: plain full-grid fixed points and the CUDA tile kernels
# ---------------------------------------------------------------------------


def _tile_cap(max_iters):
    """Rounds a tile may run at most: the plain `fixed_point` runs whole
    BLOCKs, at least one, until it stops at `max_iters` or beyond."""
    return BLOCK * max(1, -(-int(max_iters) // BLOCK))


def local_fp_plain(lslot, src, w, edge, max_iters):
    """Phase 1/4, plain: the local push fixed point G <- push(w (src + G))
    over the cut slot graph, on the whole grid at once."""
    return fixed_point(
        lambda G: _push_once(w * (src + G), lslot, edge),
        torch.zeros_like(src), max_iters,
    )


def trace_plain(slot, cross, recv, w, edge, max_iters):
    """Phase 2, plain: the chain-exit pointer X and delivery coefficient D.
    Flux arriving at a cell is delivered to entry cell X (global flat index
    in the NEIGHBOR tile) with weight D; roots deliver nowhere."""
    is_root = slot < 0
    X0 = torch.where(cross, recv, -1)
    # D = w on every edge-bearing cell, 0 at roots (cross cells are never
    # roots, so no special case).
    D0 = torch.where(is_root, 0.0, w)
    in_tile = ~cross & ~is_root

    def trace(c):
        X, D = c
        Xr = _pull(X, slot, edge, -1)
        Dr = _pull(D, slot, edge, 0.0)
        return (torch.where(in_tile, Xr, X0),
                torch.where(in_tile, w * Dr, D0))

    return fixed_point(trace, (X0, D0), max_iters)


def _tile_lib():
    """The built kernel library (compiled from csrc/ at first use)."""
    from soillib_tpu_torch import _native

    lib = _native.load("tile_accumulate")
    for name in ("tile_local_fp_launch", "tile_trace_launch"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check_tile_inputs(edge, **tensors):
    shifts_for(edge)
    shape = None
    for name, (t, dtype) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (W, H) tensor")
        if shape is not None and t.shape != shape:
            raise ValueError("tile kernel inputs must share one (W, H) grid")
        shape = t.shape
    W, H = int(shape[0]), int(shape[1])
    if W * H >= 2 ** 31:
        raise ValueError("grid too large for int32 flat indices")
    return W, H


def _launch(fn_name, ptrs, W, H, edge, max_iters, device):
    n_tiles = -(-W // TILE) * -(-H // TILE)
    rounds = torch.empty(n_tiles, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(_tile_lib(), fn_name)(
            *ptrs, rounds.data_ptr(), W, H, int(edge == D8),
            _tile_cap(max_iters), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    return rounds


def local_fp_cuda(lslot, src, w, edge, max_iters):
    """Phase 1/4 on the card: one launch, one block per 128² tile, each
    cell computed once in dependency order in shared memory; a tile with
    an in-tile cycle or a depth above `_tile_cap(max_iters)` runs the
    Jacobi rounds under that cap instead. Returns (G, rounds): per tile
    (x-major over the tile grid) its dependency depth L >= 0 (the longest
    in-tile chain in edges), or -r where it took the Jacobi branch and ran
    r rounds."""
    W, H = _check_tile_inputs(edge, lslot=(lslot, torch.int32),
                              src=(src, torch.float32),
                              w=(w, torch.float32))
    out = torch.empty_like(src)
    rounds = _launch("tile_local_fp_launch",
                     (lslot.data_ptr(), src.data_ptr(), w.data_ptr(),
                      out.data_ptr()), W, H, edge, max_iters, src.device)
    tile_launches["local"] += 1
    return out, rounds


def trace_cuda(slot, w, edge, max_iters):
    """Phase 2 on the card: one launch, one block per tile, each cell
    computed once after its in-tile receiver. The kernel derives the cut
    edges and the receivers' flat indices from `slot`. Returns (X, D,
    rounds), `rounds` as in `local_fp_cuda` (L: the longest chain from a
    cell to its tile's exit or root, in edges)."""
    W, H = _check_tile_inputs(edge, slot=(slot, torch.int32),
                              w=(w, torch.float32))
    X = torch.empty_like(slot)
    D = torch.empty_like(w)
    rounds = _launch("tile_trace_launch",
                     (slot.data_ptr(), w.data_ptr(), X.data_ptr(),
                      D.data_ptr()), W, H, edge, max_iters, slot.device)
    tile_launches["trace"] += 1
    return X, D, rounds


def _receiver_graph(slot, edge):
    """Flat-index receiver graph (-1 at roots) of a slot graph."""
    W, H = slot.shape
    n = torch.arange(W * H, dtype=torch.int32,
                     device=slot.device).reshape(W, H)
    return torch.where(slot < 0, -1, _pull(n, slot, edge, 0))


class DiffableTiledAccumulate(torch.autograd.Function):
    """`accumulate_tiled` through the tile kernels with a plain reverse
    pass: the vector-Jacobian product of pointer doubling over the same
    receiver forest and edge weights (the same linear map), with
    cotangents for the value and the weights."""

    @staticmethod
    def forward(ctx, value, weight, slot, edge, max_iters):
        ctx.edge = edge
        ctx.save_for_backward(value, weight, slot)
        return _accumulate_tiled(slot, value, weight, edge, max_iters, True)

    @staticmethod
    def backward(ctx, ct):
        from soillib_tpu_torch.ops.graph import _accumulate_doubling
        from soillib_tpu_torch.ops.sweep import _vjp_checkpointed

        value, weight, slot = ctx.saved_tensors
        g = _receiver_graph(slot, ctx.edge)
        gv, gw = _vjp_checkpointed(
            (value, weight), ct, lambda v, w: _accumulate_doubling(g, v, w))
        return gv, gw, None, None, None


def accumulate_tiled(direction_slots, value, weight=None, edge: int = D8,
                     max_iters: int = None, tile_solver: str = None):
    """Exact upstream accumulation via the two-level scheme.

    Args match ops.graph_sweep.accumulate_stencil; the result equals the
    single-level fixed point / pointer doubling. `tile_solver` picks the
    phase-1/2/4 engine: "cuda" (the tile kernels; CUDA tensors only;
    reverse mode through `DiffableTiledAccumulate`), "plain" (full-grid
    fixed points, on any device), None = by device.
    """
    v = value.to(torch.float32)
    if tile_solver is None:
        tile_solver = "cuda" if v.device.type == "cuda" else "plain"
    if tile_solver not in ("cuda", "plain"):
        raise ValueError(f"unknown tile solver: {tile_solver!r}")
    w = torch.ones_like(v) if weight is None else weight.to(torch.float32)
    if tile_solver == "cuda":
        return DiffableTiledAccumulate.apply(v, w, direction_slots, edge,
                                             max_iters)
    return _accumulate_tiled(direction_slots, v, w, edge, max_iters, False)


def _accumulate_tiled(slot, v, w, edge, max_iters, use_cuda):
    """The two-level scheme on float32 value `v` and weights `w`, phases
    1/2/4 by the tile kernels (`use_cuda`) or the plain fixed points."""
    W, H = v.shape
    if W <= TILE and H <= TILE:
        if not use_cuda:
            return accumulate_stencil(slot, v, w, edge, max_iters)
        # One tile: no edge is cut and the local phase is the whole solve.
        G, _ = local_fp_cuda(slot.contiguous(), v.contiguous(),
                             w.contiguous(), edge,
                             W * H if max_iters is None else max_iters)
        return v + G
    if max_iters is None:
        # True worst case for an in-tile path (visits each tile cell once);
        # the convergence check exits at the actual longest path.
        max_iters = TILE * TILE
    # In-kernel bound: the longest IN-TILE path visits each tile cell once.
    tile_iters = min(int(max_iters), TILE * TILE)
    lslot, cross = _local_slot(W, H, slot, edge)

    # Per cell: the receiver's global flat index (x-major; 0 at roots —
    # never read there). Needed by phases 2 and 3.
    n = torch.arange(W * H, dtype=torch.int32, device=v.device).reshape(W, H)
    recv = _pull(n, slot, edge, 0)

    if use_cuda:
        v, w = v.contiguous(), w.contiguous()
        lslot, slot = lslot.contiguous(), slot.contiguous()
        G_loc = local_fp_cuda(lslot, v, w, edge, tile_iters)[0]
        X, D = trace_cuda(slot, w, edge, tile_iters)[:2]
    else:
        G_loc = local_fp_plain(lslot, v, w, edge, max_iters)
        X, D = trace_plain(slot, cross, recv, w, edge, max_iters)

    # ---- Phase 3: coarse boundary system (compact, pointer-doubled) ------
    from soillib_tpu_torch.ops.graph import operator_doubling

    bidx = _boundary_index_tensor(W, H, v.device)
    K = bidx.shape[0]

    # Everything phase 3 needs lives on boundary cells: gather once at
    # bidx and assemble the entry fluxes with a K-sized compact scatter
    # (cross-edge receivers are boundary cells by construction).
    cross_b = cross.reshape(-1)[bidx]
    recv_b = recv.reshape(-1)[bidx]
    flux_b = (w * (v + G_loc)).reshape(-1)[bidx]
    self_idx = torch.arange(K, dtype=torch.int32, device=v.device)
    recv_rank = _boundary_rank(W, H, torch.where(cross_b, recv_b, -1), 0)
    I0 = torch.zeros(K, dtype=torch.float32, device=v.device).index_add(
        0, recv_rank.long(), torch.where(cross_b, flux_b, 0.0))

    Xg = X.reshape(-1)[bidx]                               # exit target
    Dc = D.reshape(-1)[bidx]
    P = _boundary_rank(W, H, Xg, self_idx)                 # closed-form rank
    Wc = torch.where(Xg >= 0, Dc, 0.0)

    # F = total flux entering each boundary cell from other tiles:
    # F = I0 + C F with C[P[b], b] = Wc[b]; solved by operator doubling.
    F = operator_doubling(I0, P, Wc, int(np.ceil(np.log2(max(K, 2)))))

    # ---- Phase 4: inject entry fluxes and distribute in-tile -------------
    F_grid = torch.zeros(W * H, dtype=torch.float32, device=v.device)
    F_grid[bidx] = F
    F_grid = F_grid.reshape(W, H)
    if use_cuda:
        G_inj = local_fp_cuda(lslot, F_grid, w, edge, tile_iters)[0]
    else:
        G_inj = local_fp_plain(lslot, F_grid, w, edge, max_iters)
    return v + G_loc + F_grid + G_inj
