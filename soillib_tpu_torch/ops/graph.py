"""DEM flow-graph operations (counterpart of `soillib_tpu/ops/graph.py`;
reference: model/graph/graph.cu).

* `steepest` / `direction`: the per-cell neighbor loop as an argmax over K
  shifted copies of the height field (graph.cu:28-91, 202-264).
* `random_weighted`: the per-cell Gibbs CDF + inverse-transform sample
  (graph.cu:104-173) as a masked cumulative sum over the K shifted slope
  fields; the uniforms come from a `torch.Generator` (or are passed in
  as `u`, which is how the tests feed the JAX package's draws).
* `accumulate` / `accumulate_decay`: upstream accumulation over the
  receiver forest. Three exact methods:
    "doubling" — pointer-doubling contraction (the CPU default): with M
      the nilpotent weighted receiver matrix, A = (I + M^(2^j)) ... (I + M) v
      in ceil(log2 N) rounds of one scatter-add and two gathers;
    "stencil"  — the dense one-hot push to a fixed point (graph_sweep.py);
    "tiled"    — the two-level local/boundary scheme (graph_tiled.py),
      whose per-tile phases are hand-written kernels on the card (the
      default for CUDA tensors).

Edge-decay semantics match my_decay (graph.cu:383-420): the decay value
is taken *at the donor cell*, with the compacted-slot decay^1.414 quirk
(`_edge_weights`).

Functions take tensors (kept on their device) or array-likes, which go to
`device`: the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import math

import torch

from soillib_tpu_torch.core.device import as_field, seeded_generator
from soillib_tpu_torch.core.grid import D4, D8, shift_lengths, shifts_for
from soillib_tpu_torch.core.halo import NO_HALO
from soillib_tpu_torch.ops.stencil import _shift


def _neighbor_stack(h, edge: int, halo=NO_HALO):
    """(K, W, H) stack of neighbor heights (NaN out of the global domain)
    and the shift metadata."""
    shifts = shifts_for(edge)
    hp = halo.pad(h, math.nan)
    stack = torch.stack(
        [halo.crop(_shift(hp, int(dx), int(dy), math.nan))
         for dx, dy in shifts],
        dim=0,
    )
    return stack, shifts, shift_lengths(edge)


def _neighbor_flat_index(shape, edge: int, halo=NO_HALO, device="cpu"):
    """(K, W, H) int32 *global* flat index of each neighbor (unclamped ->
    garbage if out of bounds; pair with the NaN mask of
    `_neighbor_stack`)."""
    W, H = int(shape[0]), int(shape[1])
    x0, y0, Wg, Hg = halo.global_offsets(shape)
    x = x0 + torch.arange(W, dtype=torch.int32, device=device)[:, None]
    y = y0 + torch.arange(H, dtype=torch.int32, device=device)[None, :]
    return torch.stack(
        [(x + int(dx)) * Hg + (y + int(dy)) for dx, dy in shifts_for(edge)],
        dim=0,
    )


def _slopes(h, edge, halo):
    """(K, W, H) downhill slopes (h - h_k) / |shift_k|, -inf where the
    neighbor is missing."""
    nbrs, _, lens = _neighbor_stack(h, edge, halo)
    lens = torch.as_tensor(lens, device=h.device)[:, None, None]
    slopes = (h[None] - nbrs) / lens
    # NaN (out of bounds) compares false -> not steeper, like the ref skip.
    return torch.where(torch.isnan(slopes), -math.inf, slopes)


def steepest(height, edge: int = D8, halo=NO_HALO, device=None):
    """Steepest-descent receiver graph: flat index of the neighbor with the
    steepest positive downhill slope (slope = dh / |shift|); -1 at local
    minima. Ref: graph.cu:28-91. Returns (W, H) int32."""
    h = as_field(height, device)
    slopes = _slopes(h, edge, halo)
    nind = _neighbor_flat_index(h.shape, edge, halo, h.device)
    # The reference keeps the FIRST k with a strictly greater slope:
    # argmax returns the first occurrence of the maximum.
    best_k = torch.argmax(slopes, dim=0)
    best_s = torch.amax(slopes, dim=0)
    best_i = torch.gather(nind, 0, best_k[None])[0]
    return torch.where(best_s > 0.0, best_i, -1).to(torch.int32)


def direction(height, edge: int = D8, halo=NO_HALO, device=None):
    """Like `steepest` but stores the neighbor slot k (0..K-1) instead of
    the flat index; -1 at local minima. Ref: graph.cu:202-264."""
    h = as_field(height, device)
    slopes = _slopes(h, edge, halo)
    best_k = torch.argmax(slopes, dim=0)
    best_s = torch.amax(slopes, dim=0)
    return torch.where(best_s > 0.0, best_k, -1).to(torch.int32)


def random_weighted(height, edge: int = D8, seed: int = 0, offset: int = 0,
                    T: float = 1.0, *, generator=None, u=None, halo=NO_HALO,
                    device=None):
    """Stochastic multiple-flow-direction receiver graph.

    Per cell, a Gibbs distribution over downhill neighbors with
    P_k ∝ exp(dE_k / T), dE_k = (h - h_k)/|shift_k| (only dE > 0
    contributes), sampled by inverse transform. Cells with no downhill
    neighbor get -1. Ref: graph.cu:104-195.

    The per-cell uniforms are `u` when given, else drawn from `generator`,
    else from a generator on the height's device seeded from (seed,
    offset) — deterministic in (seed, offset) as the reference's
    curand_init(seed, n, offset) grid is, though not the same numbers.
    """
    h = as_field(height, device)
    nbrs = _neighbor_stack(h, edge, halo)[0]
    nind = _neighbor_flat_index(h.shape, edge, halo, h.device)
    valid = ~torch.isnan(nbrs)
    lens = torch.as_tensor(shift_lengths(edge), device=h.device)

    dE = (h[None] - nbrs) / lens[:, None, None]
    P = torch.where(valid & (dE > 0.0), torch.exp(dE / T), 0.0)
    CDF = torch.cumsum(P, dim=0)
    Z = CDF[-1]

    if u is None:
        if generator is None:
            generator = seeded_generator(h.device, seed, offset)
        u = torch.rand(tuple(h.shape), generator=generator,
                       device=generator.device, dtype=h.dtype).to(h.device)
    else:
        u = as_field(u, h.device).to(h.device)
    # First valid slot with u < CDF_k / Z; Z == 0 -> no hit -> -1 (the
    # reference's 0/0 = NaN comparison is always false, graph.cu:160).
    hit = valid & (u[None] * Z < CDF) & (Z[None] > 0.0)
    any_hit = torch.any(hit, dim=0)
    first_k = torch.argmax(hit.to(torch.uint8), dim=0)
    chosen = torch.gather(nind, 0, first_k[None])[0]
    return torch.where(any_hit, chosen, -1).to(torch.int32)


def slope(tensor, flow, scale, device=None):
    """Directional slope along the receiver graph:
    (val[next] - val[n]) / |scale * (pos_next - pos)|; 0 at pits/self.
    Ref: graph.cu:270-311."""
    v = as_field(tensor, device)
    f = as_field(flow, v.device, dtype=torch.int32).to(v.device)
    W, H = v.shape
    n = torch.arange(W * H, dtype=torch.int32, device=v.device).reshape(W, H)
    nxt = torch.where(f < 0, n, f)

    vn = v.reshape(-1)[nxt.long()]
    dx = (nxt // H - n // H).to(v.dtype) * scale[0]
    dy = (nxt % H - n % H).to(v.dtype) * scale[1]
    dist = torch.sqrt(dx * dx + dy * dy)
    out = torch.where((f < 0) | (f == n), 0.0,
                      (vn - v) / torch.where(dist == 0, 1.0, dist))
    return out.to(v.dtype)


def graph_to_slots(graph, edge: int = D8):
    """Flat-index receiver graph -> neighbor-slot graph ((W, H) int32 of
    slot indices 0..K-1, -1 at roots). Receivers are always one of the K
    neighbors, so the conversion is a dense offset match."""
    g = graph
    W, H = g.shape
    n = torch.arange(W * H, dtype=torch.int32, device=g.device).reshape(W, H)
    recv = torch.where(g < 0, n, g)
    dx = recv // H - n // H
    dy = recv % H - n % H
    slot = torch.full((W, H), -1, dtype=torch.int32, device=g.device)
    for d, (sx, sy) in enumerate(shifts_for(edge)):
        slot = torch.where((dx == int(sx)) & (dy == int(sy)) & (g >= 0), d,
                           slot)
    return slot.to(torch.int32)


def _edge_weights(graph, decay, edge: int):
    """Per-cell edge weight w_i for the edge i -> recv[i].

    decay: None (weight 1), a scalar, or a (W, H) tensor, evaluated at the
    donor cell. The decay^1.414 exponent follows the reference FAITHFULLY:
    my_decay (graph.cu:383-420) runs AFTER __count compacts each cell's
    donor list (graph.cu:351-380), so the exponent applies to donors in
    COMPACTED slots >= 4 — the 5th+ donor of the receiving cell in
    direction-slot order — NOT to geometrically-diagonal edges (a cell
    with <= 4 donors never gets the exponent). A quirk of the reference's
    compaction, reproduced on purpose.
    """
    W, H = graph.shape
    dev = graph.device
    if decay is None:
        return torch.ones((W, H), dtype=torch.float32, device=dev)
    d = torch.as_tensor(decay, dtype=torch.float32, device=dev)
    if d.dim() == 0:
        # expand, not a fresh tensor: a decay that requires grad keeps it.
        d = d.expand(W, H)
    if edge == D4:
        # my_decay<D4>: all compacted slots < 4 -> never the exponent.
        return d

    slot = graph_to_slots(graph, edge)
    shifts = shifts_for(edge)
    # P_d[j] = 1 if j has a donor via direction d (the donor sits at
    # j - shift_d and its slot is d).
    P = [torch.roll((slot == dd).to(torch.int32), (int(dx), int(dy)),
                    dims=(0, 1))
         for dd, (dx, dy) in enumerate(shifts)]
    # prefix_d[j] = number of donors of j with slot < d.
    prefix = []
    acc = torch.zeros((W, H), dtype=torch.int32, device=dev)
    for dd in range(len(shifts)):
        prefix.append(acc)
        acc = acc + P[dd]
    # Donor i's compacted position = prefix_{slot(i)}[recv(i)] — pull the
    # receiver's prefix along the donor's own direction.
    pos = torch.zeros((W, H), dtype=torch.int32, device=dev)
    for dd, (dx, dy) in enumerate(shifts):
        pulled = torch.roll(prefix[dd], (-int(dx), -int(dy)), dims=(0, 1))
        pos = torch.where(slot == dd, pulled, pos)
    return torch.where((slot >= 0) & (pos >= 4), torch.pow(d, 1.414), d)


def operator_doubling(F, P, W, rounds):
    """Solve F <- F + C F for nilpotent C encoded by per-node pointer P and
    weight W (C[P[i], i] = W[i]; roots self-point with W = 0), by operator
    squaring: up to `rounds` = ceil(log2(#nodes)) rounds of

        F += scatter_add(P, W * F);  W *= W[P];  P = P[P].

    Once W is identically zero, C^(2^r) = 0 and every further round is an
    exact no-op, so the loop stops there: one host read of `any(W != 0)`
    per round (the JAX version's lax.cond). Reverse-differentiable."""
    P = P.long()
    for _ in range(int(rounds)):
        if not bool(torch.any(W != 0.0)):
            break
        F = F + torch.zeros_like(F).index_add(0, P, W * F)
        W = W * W[P]
        P = P[P]
    return F


def compact_index(ids, queries, fallback, device=None):
    """Map global ids -> compact positions without a grid-sized lookup
    table: sort + searchsorted (ids are unique). Queries < 0 (or absent)
    map to `fallback` per element. Returns int32."""
    ids = as_field(ids, device, dtype=torch.int32)
    queries = as_field(queries, ids.device, dtype=torch.int32).to(ids.device)
    order = torch.argsort(ids)
    sorted_ids = ids[order]
    q = torch.where(queries >= 0, queries, 0)
    pos = torch.clamp(torch.searchsorted(sorted_ids, q), 0, ids.shape[0] - 1)
    hit = (queries >= 0) & (sorted_ids[pos] == q)
    fallback = torch.as_tensor(fallback, dtype=torch.int32, device=ids.device)
    return torch.where(hit, order[pos].to(torch.int32), fallback)


def _doubling_pointers(graph):
    """Flat receiver pointers with roots (receiver < 0 or itself) pointing
    at themselves, the root mask, and ceil(log2 N) doubling rounds."""
    W, H = graph.shape
    N = W * H
    n = torch.arange(N, dtype=torch.int32, device=graph.device)
    g = graph.reshape(-1)
    root = (g < 0) | (g == n)
    rounds = max(1, int(math.ceil(math.log2(max(N, 2)))))
    return torch.where(root, n, g).long(), root, rounds


def upstream_mask(graph, targets, device=None):
    """Boolean mask of cells draining into any target cell (including the
    targets). `targets` is a boolean (W, H) mask. Pointer-doubling descent
    over ceil(log2 N) rounds (the legacy `soil.upstream` surface,
    model.cpp:436-444)."""
    g = as_field(graph, device, dtype=torch.int32)
    P, _, rounds = _doubling_pointers(g)
    hit = as_field(targets, g.device, dtype=torch.bool).to(g.device)
    hit = hit.reshape(-1)
    for _ in range(rounds):
        hit = hit | hit[P]
        P = P[P]
    return hit.reshape(g.shape)


def upstream_distance(graph, device=None):
    """Hop distance along the receiver chain to the terminal root of each
    cell (0 for roots), int32; pointer doubling over ceil(log2 N) rounds
    (the legacy `soil.distance` surface, model.cpp:446-455)."""
    g = as_field(graph, device, dtype=torch.int32)
    P, root, rounds = _doubling_pointers(g)
    D = torch.where(root, 0, 1).to(torch.int32)
    for _ in range(rounds):
        D = D + D[P]
        P = P[P]
    return D.reshape(g.shape)


def _accumulate_doubling(graph, value, weight):
    """Upstream accumulation by pointer doubling (module docstring)."""
    P, root, rounds = _doubling_pointers(graph)
    Wt = torch.where(root, 0.0, weight.reshape(-1).to(torch.float32))
    A = value.reshape(-1).to(torch.float32)
    return operator_doubling(A, P, Wt, rounds).reshape(graph.shape)


def _auto_method(method, g):
    """The accumulation method for receiver graph `g`: the caller's, else
    "tiled" for CUDA tensors (its tile phases are the card's kernels, and
    one tile is a single local phase), else "doubling" (O(log N) gathers,
    fast on the CPU), as the JAX package picks off the TPU."""
    if method is not None:
        return method
    return "tiled" if g.device.type == "cuda" else "doubling"


def _accumulate_dispatch(g, value, w, edge, method, max_iters):
    shifts_for(edge)  # validate up front: the doubling path never reads it
    # Scalar value == uniform rain; broadcast so every method sees (W, H).
    value = torch.broadcast_to(
        torch.as_tensor(value, dtype=torch.float32, device=g.device), g.shape)
    method = _auto_method(method, g)
    if method == "tiled":
        from soillib_tpu_torch.ops.graph_tiled import accumulate_tiled

        return accumulate_tiled(graph_to_slots(g, edge), value, w, edge,
                                max_iters)
    if method == "stencil":
        from soillib_tpu_torch.ops.graph_sweep import accumulate_stencil

        return accumulate_stencil(graph_to_slots(g, edge), value, w, edge,
                                  max_iters)
    if method == "doubling":
        if w is None:
            w = _edge_weights(g, None, edge)
        return _accumulate_doubling(g, value, w)
    raise ValueError(f"unknown accumulation method: {method!r}")


def accumulate(graph, value, edge: int = D8, *, method: str = None,
               max_iters: int = None, device=None):
    """Upstream accumulation: out[j] = value[j] + sum_{i upstream of j}
    value[i]. Ref: graph.cu:527-584 (rake-compress). Methods: "doubling",
    "stencil", "tiled" (module docstring); None picks by device."""
    g = as_field(graph, device, dtype=torch.int32)
    return _accumulate_dispatch(g, value, None, edge, method, max_iters)


def accumulate_decay(graph, source, decay, edge: int = D8, *,
                     method: str = None, max_iters: int = None, device=None):
    """Upstream accumulation with per-edge decay: each hop i -> recv[i]
    multiplies by decay[i] (donor cell), compacted slots >= 4 by
    decay[i]^1.414 (`_edge_weights`). Ref: graph.cu:586-593."""
    g = as_field(graph, device, dtype=torch.int32)
    w = _edge_weights(g, decay, edge)
    return _accumulate_dispatch(g, source, w, edge, method, max_iters)
