"""Distributed flow accumulation: block-local contraction and a global
boundary system over the rank mesh (counterpart of
`soillib_tpu/parallel/graph.py`).

The two-level scheme of ops/graph_tiled.py, lifted one level: each rank's
block plays the outer tile. Per block:

  1. LOCAL   - cut the cross-block edges and solve the block forest exactly
               with the single-device tiled accumulator (on the card: the
               tile push and trace kernels, nesting their own 128-tiling
               inside the block).
  2. TRACE   - each cell's block-exit destination (global cell id) and
               path weight, by pointer doubling over the cut forest
               (ceil(log2(bw * bh)) rounds of gathers at most; the JAX
               package iterates a one-hop fixed point for as many rounds
               as the longest in-block path).
  3. EXCHANGE + COARSE - the cross-block out-fluxes hop to the neighbour
               blocks' edge rings through one 1-ring halo exchange; the
               ring cells of all blocks form a small global linear system,
               all-gathered and solved on every rank by `compact_index`
               and `operator_doubling` (2 (bw + bh) - 4 cells a block).
  4. INJECT  - scatter the ring fluxes back and distribute them in-block
               with the tiled accumulator on the cut forest again.

Exact for arbitrary per-donor weights; held against the single-device
methods (tests/test_torch_parallel_graph.py). Global flat cell ids are
int32, so grids beyond 2^31 cells (~46341^2) need an int64 id path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from soillib_tpu_torch.core.device import as_field
from soillib_tpu_torch.core.grid import D4, D8, shifts_for
from soillib_tpu_torch.ops.graph import (
    _edge_weights,
    compact_index,
    operator_doubling,
)
from soillib_tpu_torch.ops.graph_tiled import accumulate_tiled
from soillib_tpu_torch.parallel.halo import ShardHalo


def _ring_indices(bw, bh):
    """Block-local flat indices of the block's edge ring (x-major)."""
    x = np.arange(bw)[:, None]
    y = np.arange(bh)[None, :]
    mask = (x == 0) | (x == bw - 1) | (y == 0) | (y == bh - 1)
    return np.flatnonzero(mask.reshape(-1))


def _block_slots(g, halo, edge):
    """Neighbour-slot graph (-1 at roots) of a block of a global flat
    receiver graph (`ops.graph.graph_to_slots` on the global ids)."""
    bw, bh = g.shape
    x0, y0, _, Hg = halo.global_offsets((bw, bh))
    gx = x0 + torch.arange(bw, dtype=torch.int32, device=g.device)[:, None]
    gy = y0 + torch.arange(bh, dtype=torch.int32, device=g.device)[None, :]
    dx = torch.div(g, Hg, rounding_mode="floor") - gx
    dy = torch.remainder(g, Hg) - gy
    slot = torch.full((bw, bh), -1, dtype=torch.int32, device=g.device)
    for d, (sx, sy) in enumerate(shifts_for(edge)):
        slot = torch.where((dx == int(sx)) & (dy == int(sy)) & (g >= 0), d,
                           slot)
    return slot


def _block_weights(slot, decay, halo, edge):
    """Per-donor edge weights of the block (`ops.graph._edge_weights`, the
    decay^1.414 quirk of compacted slots >= 4 included). A donor's
    compacted slot counts the donors of its receiver, up to 2 cells away,
    so the slots and the decay are padded by a 2-ring (no edges and decay
    0 outside the domain) and the single-device rule runs on the padded
    block's local graph."""
    bw, bh = slot.shape
    dev = slot.device
    if decay is None:
        return torch.ones((bw, bh), dtype=torch.float32, device=dev)
    d = torch.as_tensor(decay, dtype=torch.float32, device=dev)
    if d.dim() == 0:
        d = d.expand(bw, bh)
    if edge == D4:
        return d
    sp = halo.pad(slot, -1, 2)
    dp = halo.pad(d.contiguous(), 0.0, 2)
    W, H = sp.shape
    n = torch.arange(W * H, dtype=torch.int32, device=dev).reshape(W, H)
    recv = torch.full((W, H), -1, dtype=torch.int32, device=dev)
    for k, (sx, sy) in enumerate(shifts_for(edge)):
        recv = torch.where(sp == k, n + int(sx) * H + int(sy), recv)
    return halo.crop(_edge_weights(recv, dp, edge), 2).contiguous()


def _block_cut(slot, edge):
    """Cut the edges leaving the block: slot -> -1 there; also returns the
    cross-block mask."""
    bw, bh = slot.shape
    x = torch.arange(bw, device=slot.device)[:, None]
    y = torch.arange(bh, device=slot.device)[None, :]
    cross = torch.zeros((bw, bh), dtype=torch.bool, device=slot.device)
    for d, (dx, dy) in enumerate(shifts_for(edge)):
        oob = (((x + int(dx)) < 0) | ((x + int(dx)) >= bw)
               | ((y + int(dy)) < 0) | ((y + int(dy)) >= bh))
        cross = cross | ((slot == d) & oob)
    return torch.where(cross, -1, slot), cross


def _exit_trace(lslot, X0, D0, w, edge):
    """Phase 2: per cell, the block-exit destination X (the global id of
    the receiver across the block edge, -1 for a chain that ends at a root)
    and the path weight D (the product of w along the chain, the exit
    cell's w included; 0 at roots), by pointer doubling over the cut
    forest: ptr jumps to ptr[ptr] and the segment products multiply until
    every pointer sits on its chain's end."""
    bw, bh = lslot.shape
    dev = lslot.device
    n = torch.arange(bw * bh, dtype=torch.int64, device=dev).reshape(bw, bh)
    ptr = n.clone()
    for d, (dx, dy) in enumerate(shifts_for(edge)):
        ptr = torch.where(lslot == d, n + int(dx) * bh + int(dy), ptr)
    ptr = ptr.reshape(-1)
    inner = (lslot >= 0).reshape(-1)
    M = torch.where(inner, w.reshape(-1), 1.0)
    for _ in range(max(1, math.ceil(math.log2(max(bw * bh, 2))))):
        nxt = ptr[ptr]
        if not bool(torch.any(nxt != ptr)):
            break
        M = M * M[ptr]
        ptr = nxt
    X = X0.reshape(-1)[ptr].reshape(bw, bh)
    D = (M * D0.reshape(-1)[ptr]).reshape(bw, bh)
    return X, D


def _all_gather(mesh, t):
    """Every rank's `t`, concatenated along dim -1 in rank order, on every
    rank."""
    if not mesh.distributed:
        return t
    send = t.cpu() if mesh.host_staged else t.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send)
    return torch.cat(parts, dim=-1).to(t.device)


def _local_accumulate(mesh, edge, max_iters, slot, v, w):
    halo = ShardHalo(mesh)
    bw, bh = v.shape
    dev = v.device
    shifts = shifts_for(edge)
    lslot, cross = _block_cut(slot, edge)
    is_root = slot < 0

    # Phase 1: exact block-local accumulation on the cut forest.
    G_loc = accumulate_tiled(lslot, v, w, edge, max_iters) - v

    # Phase 2: exit destination (GLOBAL cell id) and path weight.
    x0, y0, _, Hg = halo.global_offsets((bw, bh))
    gx = x0 + torch.arange(bw, dtype=torch.int32, device=dev)[:, None]
    gy = y0 + torch.arange(bh, dtype=torch.int32, device=dev)[None, :]
    X0 = torch.full((bw, bh), -1, dtype=torch.int32, device=dev)
    for d, (dx, dy) in enumerate(shifts):
        X0 = torch.where((slot == d) & cross,
                         (gx + int(dx)) * Hg + (gy + int(dy)), X0)
    # D0 = w on every edge-bearing cell, 0 at roots (cross cells are never
    # roots).
    D0 = torch.where(is_root, 0.0, w)
    X, D = _exit_trace(lslot, X0, D0, w, edge)

    # Phase 3a: ship the cross-block out-fluxes to the neighbours' edge
    # rings (one 1-ring exchange of all directions; arrivals land where
    # the edges point).
    out = torch.stack([torch.where((slot == d) & cross, w * (v + G_loc), 0.0)
                       for d in range(len(shifts))])
    outp = halo.pad_cf(out, 0.0)
    I0 = torch.zeros((bw, bh), dtype=torch.float32, device=dev)
    for d, (dx, dy) in enumerate(shifts):
        I0 = I0 + halo.crop(torch.roll(outp[d], (int(dx), int(dy)),
                                       dims=(0, 1)))

    # Phase 3b: compact the ring data, all-gather, solve on every rank.
    ridx = torch.as_tensor(_ring_indices(bw, bh), device=dev)
    my_gid = (gx * Hg + gy).reshape(-1)[ridx]
    ring = torch.stack([
        I0.reshape(-1)[ridx], X.reshape(-1)[ridx].view(torch.float32),
        D.reshape(-1)[ridx], my_gid.view(torch.float32)])
    I0c, Xc, Dc, Gc = _all_gather(mesh, ring)
    Xc, Gc = Xc.view(torch.int32), Gc.view(torch.int32)
    K = I0c.shape[0]
    self_idx = torch.arange(K, dtype=torch.int32, device=dev)
    Pp = compact_index(Gc, Xc, self_idx)
    Wc = torch.where(Xc >= 0, Dc, 0.0)
    F = operator_doubling(I0c, Pp, Wc, int(np.ceil(np.log2(max(K, 2)))))

    # Phase 4: my ring's fluxes, injected and distributed in-block.
    Kb = ridx.shape[0]
    F_grid = torch.zeros(bw * bh, dtype=torch.float32, device=dev)
    F_grid[ridx] = F[mesh.rank * Kb:(mesh.rank + 1) * Kb]
    F_grid = F_grid.reshape(bw, bh)
    G_inj = accumulate_tiled(lslot, F_grid, w, edge, max_iters) - F_grid
    return v + G_loc + F_grid + G_inj


def accumulate(graph, value, edge: int = D8, *, mesh, decay=None,
               max_iters: int = None):
    """Distributed upstream accumulation (optionally decayed) of this
    rank's block. `graph` is the block of the global flat receiver graph
    (the sharded `parallel.ops.steepest` output), `value` the block of the
    source (or a scalar), `decay` None, a scalar or the block of a (W, H)
    field. Returns the block of the accumulation."""
    g = as_field(graph, mesh.device, dtype=torch.int32)
    bw, bh = g.shape
    halo = ShardHalo(mesh)
    if max_iters is None:
        max_iters = bw * bh
    slot = _block_slots(g, halo, edge)
    w = _block_weights(slot, decay, halo, edge)
    v = torch.broadcast_to(as_field(value, mesh.device), (bw, bh))
    return _local_accumulate(mesh, edge, int(max_iters), slot,
                             v.contiguous(), w.contiguous())
