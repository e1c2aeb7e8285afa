"""Stencil-form flow accumulation (counterpart of
`soillib_tpu/ops/graph_sweep.py`).

Every receiver-graph edge points to one of the 8 NEIGHBORS, so one
accumulation hop is a dense 8-direction one-hot push

    A' = v + PUSH_w(A),   PUSH_w(A)[j] = sum_{d} w * A[j - shift_d]
                                          where slot[j - shift_d] == d,

and its fixed point — reached after L rounds, L = longest drainage path —
is the exact upstream accumulation (with per-donor decay weights,
accumulate_decay's my_decay semantics, graph.cu:383-420). Convergence is
detected every BLOCK rounds by a bitwise compare (values stop changing
exactly once all paths have resolved), bounded by `max_iters`.

Plain torch. The tiled scheme (ops/graph_tiled.py) runs these same
fixed points per 128² tile, in a hand-written kernel on the card; the
full-grid forms here are what that kernel is held against.
"""

from __future__ import annotations

import torch

from soillib_tpu_torch.core.grid import D8, shifts_for

BLOCK = 32  # rounds between convergence checks


def _bits(a):
    """Bit pattern of a tensor (NaN-safe equality: NaN != NaN would make a
    value-compare convergence check spin for max_iters)."""
    if torch.is_floating_point(a):
        nbits = torch.finfo(a.dtype).bits
        return a.view({16: torch.int16, 32: torch.int32,
                       64: torch.int64}[nbits])
    return a


def changed(a, b):
    """True (0-dim bool tensor) if any element's BIT PATTERN differs —
    the exact fixed-point test, which also ends once NaNs have settled."""
    return torch.any(_bits(a) != _bits(b))


def _any_changed(cur, prev):
    if isinstance(cur, tuple):
        return any(bool(changed(c, p)) for c, p in zip(cur, prev))
    return bool(changed(cur, prev))


def fixed_point(step, init, max_iters):
    """Iterate `step` until bitwise convergence, checked every BLOCK rounds
    (one host read each); `init` is a tensor or a tuple of tensors. Runs
    BLOCK rounds at least and stops at the first check that finds no
    change or once `max_iters` rounds have run, as the JAX loop does."""
    def block(c):
        for _ in range(BLOCK):
            c = step(c)
        return c

    cur, prev, it = block(init), init, BLOCK
    while _any_changed(cur, prev) and it < max_iters:
        cur, prev, it = block(cur), cur, it + BLOCK
    return cur


def roll2(a, dx, dy):
    """torch.roll by (dx, dy) over the first two dims, skipping zero
    shifts."""
    if dx:
        a = torch.roll(a, dx, dims=0)
    if dy:
        a = torch.roll(a, dy, dims=1)
    return a


def _push_once(payload, slot, edge):
    """Dense one-hot push: each cell sends `payload` to its receiver.

    torch.roll wraps, but receivers never point off-grid (out-of-bounds
    neighbors have NaN slope and are never selected by steepest/
    direction/random_weighted), so every wrapped lane carries zero.
    """
    shifts = shifts_for(edge)
    out = torch.zeros_like(payload)
    for d, (dx, dy) in enumerate(shifts):
        contrib = torch.where(slot == d, payload, 0.0)
        out = out + roll2(contrib, int(dx), int(dy))
    return out


def accumulate_stencil(direction_slots, value, weight=None, edge: int = D8,
                       max_iters: int = None):
    """Upstream accumulation from a *direction-slot* graph ((W, H) int32 of
    neighbor slots, -1 at roots — the `direction` op's output).

    Args:
      direction_slots: (W, H) int32 receiver slots.
      value: (W, H) per-cell source.
      weight: optional (W, H) per-donor edge weight (already including the
        diagonal exponent — use ops.graph._edge_weights).
      edge: D4/D8.
      max_iters: hard bound on rounds. Default W*H — the true worst-case
        path length, so the result is always exact.

    Returns (W, H) float32: value + weighted upstream sum.
    """
    slot = direction_slots
    v = value.to(torch.float32)
    W, H = v.shape
    if max_iters is None:
        max_iters = W * H
    w = torch.ones_like(v) if weight is None else weight.to(torch.float32)
    G = fixed_point(
        lambda G: _push_once(w * (v + G), slot, edge), torch.zeros_like(v),
        max_iters,
    )
    return v + G
