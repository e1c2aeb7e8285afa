"""Halo exchange over the rank mesh (`torch.distributed` neighbour shifts;
counterpart of `soillib_tpu/parallel/halo.py`).

Implements the `core.halo` protocol for 2-D block decomposition: `pad`
grows each block by an r-wide ring holding the neighbouring blocks' edge
slabs, exchanged as two non-periodic shifts, x first, then y on the
already-x-padded block, so the corner cells arrive in the second hop from
the diagonal neighbour's data (no corner messages). Each shift posts both
directions of one mesh axis in one `dist.batch_isend_irecv`: this block's
low slab to the -1 neighbour, its high slab to the +1 neighbour. Every
rank shifts x before y, and a block at the domain edge skips the missing
neighbour and fills that ring with the op's own boundary condition
(`fill`: a constant or "edge"), which is what makes sharded execution
equal to single-device execution.

On the gloo transport with blocks on the card the slabs are copied to
pinned host memory, sent, and the received slabs copied back with
non_blocking=True; every compute op stays on the card.

The exchanges are not differentiable: a sharded op on a tensor that
requires grad raises (the sharded step has no reverse mode).
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

# Halo-traffic ledger: while enabled (the `halo_ledger` context manager),
# every exchange along a mesh axis with more than one block records
# (axis_name, payload_bytes, sent_bytes, seconds): the two edge slabs of
# the exchange (the JAX package's per-device count), the bytes this rank
# actually sent (a block at the domain edge sends one slab), and with
# timed=True the host seconds from posting to the received ring (the
# device synchronised first, so no earlier work is counted), else None.
# Opt-in, so a long run does not grow the list without bound.
HALO_BYTES = []
_LEDGER = {"on": False, "timed": False}


class halo_ledger:
    """`with halo_ledger(timed=False) as entries:` clear HALO_BYTES,
    record the traffic of every halo exchange inside the block (timed:
    synchronise the device around each exchange and time it)."""

    def __init__(self, timed: bool = False):
        self.timed = bool(timed)

    def __enter__(self):
        HALO_BYTES.clear()
        _LEDGER.update(on=True, timed=self.timed)
        return HALO_BYTES

    def __exit__(self, *exc):
        _LEDGER.update(on=False, timed=False)
        return False


def _overlap_enabled() -> bool:
    """Opt-in interior/boundary-band overlap schedule of `run_cohort`
    (SOIL_HALO_OVERLAP=1): the interior advance runs while the x slabs are
    in flight, then four boundary bands advance with the arrived ring.
    Off by default: the bands recompute 4 x 3K-wide strips of the block
    each pass. Read at each call so tests can toggle it."""
    return os.environ.get("SOIL_HALO_OVERLAP", "0") == "1"


def _refuse_grad(*tensors):
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise NotImplementedError(
            "the sharded path has no reverse mode (the halo exchanges are "
            "not differentiable); run it under torch.no_grad() or on one "
            "device")


def _fill_slab(arr, fill, axis: int, lo: bool, radius: int):
    """Boundary-ring values: a constant, or clamp-to-edge replication."""
    if isinstance(fill, str):
        if fill != "edge":
            raise ValueError(f"unknown fill mode: {fill!r}")
        n = arr.shape[axis]
        edge = arr.narrow(axis, 0 if lo else n - 1, 1)
        reps = [1] * arr.dim()
        reps[axis] = radius
        return edge.repeat(reps)
    shape = list(arr.shape)
    shape[axis] = radius
    return torch.full(shape, fill, dtype=arr.dtype, device=arr.device)


class _Pending:
    """A posted neighbour shift: its requests and receive buffers."""

    def __init__(self, mesh, ops, reqs, from_lo, from_hi):
        # The ops hold the send buffers until the requests complete.
        self.mesh, self.ops, self.reqs = mesh, ops, reqs
        self.from_lo, self.from_hi = from_lo, from_hi

    def wait(self):
        """(slab from the -1 neighbour, slab from the +1 neighbour) on the
        mesh's device; None where there is no neighbour."""
        for r in self.reqs:
            r.wait()
        staged = self.mesh.host_staged

        def back(h):
            if h is None or not staged:
                return h
            return h.to(self.mesh.device, non_blocking=True)

        return back(self.from_lo), back(self.from_hi)


def post_shift(mesh, axis: int, lo_slab, hi_slab) -> _Pending:
    """Post one shift along mesh axis `axis`: `lo_slab` to the -1
    neighbour, `hi_slab` to the +1 neighbour, and the receives of their
    facing slabs, in one batch."""
    lo, hi = mesh.neighbor(axis, -1), mesh.neighbor(axis, +1)
    staged = mesh.host_staged

    def wire(t):
        if staged:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            return h
        return t.contiguous()

    def inbox(like):
        if staged:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)

    ops, from_lo, from_hi = [], None, None
    if lo is not None:
        from_lo = inbox(hi_slab)
        ops += [dist.P2POp(dist.isend, wire(lo_slab), lo),
                dist.P2POp(dist.irecv, from_lo, lo)]
    if hi is not None:
        from_hi = inbox(lo_slab)
        ops += [dist.P2POp(dist.isend, wire(hi_slab), hi),
                dist.P2POp(dist.irecv, from_hi, hi)]
    reqs = dist.batch_isend_irecv(ops) if ops else []
    return _Pending(mesh, ops, reqs, from_lo, from_hi)


def _post_axis(arr, mesh, mesh_axis: int, axis: int, radius: int):
    n = arr.shape[axis]
    if radius > n:
        raise ValueError(f"halo radius {radius} exceeds block extent {n}")
    _refuse_grad(arr)
    lo_slab = arr.narrow(axis, 0, radius)
    hi_slab = arr.narrow(axis, n - radius, radius)
    if mesh.shape[mesh_axis] > 1 and _LEDGER["on"]:
        nb = lo_slab.numel() * lo_slab.element_size()
        sent = nb * sum(mesh.neighbor(mesh_axis, s) is not None
                        for s in (-1, 1))
        HALO_BYTES.append((mesh.axis_names[mesh_axis], 2 * nb, sent, None))
    return post_shift(mesh, mesh_axis, lo_slab, hi_slab)


def _finish_axis(arr, pending, axis: int, fill, radius: int):
    from_lo, from_hi = pending.wait()
    if from_lo is None:
        from_lo = _fill_slab(arr, fill, axis, True, radius)
    if from_hi is None:
        from_hi = _fill_slab(arr, fill, axis, False, radius)
    return torch.cat([from_lo, arr, from_hi], dim=axis)


def exchange_axis(arr, mesh, mesh_axis: int, axis: int, fill, radius: int):
    """Pad `arr` along tensor dim `axis` with the edge slabs of the
    neighbouring blocks along mesh axis `mesh_axis`; the shift does not
    wrap, and a block at the domain edge fills the missing side with
    `fill`."""
    timed = _LEDGER["timed"] and mesh.shape[mesh_axis] > 1
    if timed:
        _sync(arr.device)
        t0 = time.perf_counter()
    pending = _post_axis(arr, mesh, mesh_axis, axis, radius)
    out = _finish_axis(arr, pending, axis, fill, radius)
    if timed:
        _sync(arr.device)
        HALO_BYTES[-1] = HALO_BYTES[-1][:3] + (time.perf_counter() - t0,)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cohort_advance(st, aux, G, rules, rounds, Llen, closure):
    """`rounds` cohort rounds of a (padded) block from deposits G: the
    cohort kernel on the card, the plain rounds on the CPU."""
    from soillib_tpu_torch.ops import cohort as CO

    if st.device.type == "cuda":
        # Positional: chip_smoke.py records these calls by their args.
        return CO.cohort_advance_cuda(st, aux, rules, rounds, Llen, 0.0,
                                      closure, G)
    return CO.cohort_advance_reference(st, aux, rules, rounds, Llen,
                                       closure=closure, G=G)


class ShardHalo:
    """Halo provider of one rank of a `Mesh`: the ops of the single-device
    path, called with `halo=ShardHalo(mesh)` in every rank, run as one
    block-decomposed program."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.px, self.py = mesh.shape
        self.ax_name, self.ay_name = mesh.axis_names

    def pad(self, arr, fill, radius: int = 1):
        arr = exchange_axis(arr, self.mesh, 0, 0, fill, radius)
        return exchange_axis(arr, self.mesh, 1, 1, fill, radius)

    def crop(self, arr, radius: int = 1):
        r = radius
        return arr[r:-r, r:-r, ...]

    def global_offsets(self, block_shape):
        bw, bh = int(block_shape[0]), int(block_shape[1])
        cx, cy = self.mesh.coord
        return cx * bw, cy * bh, bw * self.px, bh * self.py

    def pad_cf(self, arr, fill, radius: int = 1):
        """Pad the LAST two (spatial) dims: channel-first layout."""
        arr = exchange_axis(arr, self.mesh, 0, arr.dim() - 2, fill, radius)
        return exchange_axis(arr, self.mesh, 1, arr.dim() - 1, fill, radius)

    def crop_cf(self, arr, radius: int = 1):
        r = radius
        return arr[..., r:-r, r:-r]

    @staticmethod
    def _ring(bw, bh):
        """The ring width of the K-blocked passes: HALO_K, or 1 (one round
        a pass) when a block is narrower than HALO_K."""
        from soillib_tpu_torch.ops.sweep import HALO_K

        return HALO_K if bw >= HALO_K and bh >= HALO_K else 1

    def run_transport(self, E, att, vx, vy, iters: int):
        """Temporally blocked distributed transport: one K-wide exchange of
        G before each K-round advance of the padded block (the sweep
        kernel on the card, `sweep.transport_advance`), the block interior
        kept. Each cell's rounds see exactly the inputs of the
        single-device solve (the trapezoid argument of ops/sweep.py at the
        block boundary). Blocks narrower than K exchange a 1-cell ring
        every round."""
        from soillib_tpu_torch.ops import sweep as S

        k = self._ring(E.shape[-2], E.shape[-1])
        Ep, attp, vxp, vyp = (self.pad_cf(t, 0.0, k).contiguous()
                              for t in (E, att, vx, vy))
        G = torch.zeros_like(E)
        n_full, rem = divmod(int(iters), k)
        for r in [k] * n_full + ([rem] if rem else []):
            Gp = self.pad_cf(G, 0.0, k).contiguous()
            G = self.crop_cf(S.transport_advance(Gp, Ep, attp, vxp, vyp, r),
                             k).contiguous()
        return G

    def run_cohort(self, st0, aux, rules, iters: int, Llen, closure=None,
                   tol: float = 0.0):
        """K-blocked distributed cohort sweep: exchange a K-wide ring of the
        cohort state, advance K rounds on the padded block (the cohort
        kernel on the card, `cohort_advance_cuda`, under the closure's
        variant), keep the block interior of the state and of the
        deposits, which accumulate onto the block's own (each cell's
        deposits add round by round in the single-device order). Then
        the remainder pass.

        `tol` > 0: before each pass (every K rounds, where the
        single-device kernel path reads its exit too) the live carried
        mass and the deposit gauge are summed over the mesh, so every
        rank takes the same exit. SOIL_HALO_OVERLAP=1 selects the
        interior/band schedule (`_pass_overlap`) for blocks >= 4K."""
        from soillib_tpu_torch.ops import cohort as CO

        st = CO.as_stack(st0).contiguous()
        aux = CO.as_stack(aux).contiguous()
        bw, bh = st.shape[-2], st.shape[-1]
        k = self._ring(bw, bh)
        auxp = self.pad_cf(aux, 0.0, k).contiguous()
        C = CO.n_deposits(st.shape[0], closure)
        G = torch.zeros((C, bw, bh), dtype=st.dtype, device=st.device)
        overlap = (k > 1 and _overlap_enabled() and bw >= 4 * k
                   and bh >= 4 * k)
        one_pass = self._pass_overlap if overlap else self._pass_seq
        contractive = bool(getattr(rules, "contractive", False))
        n_full, rem = divmod(int(iters), k)
        done = 0
        for r in [k] * n_full + ([rem] if rem else []):
            if tol and tol > 0.0:
                live = self.mesh.all_reduce(CO.carried_live(st, closure))
                gauge = self.mesh.all_reduce(CO.deposit_gauge(G))
                if bool(CO.tail_converged(live, gauge, float(iters) - done,
                                          tol, contractive)):
                    break
            st, G = one_pass(st, G, aux, auxp, rules, r, Llen, closure, k)
            done += r
        return G

    def _pass_seq(self, st, G, aux, auxp, rules, r, Llen, closure, k):
        """Exchange, then one r-round advance of the padded block."""
        stp = self.pad_cf(st, 0.0, k).contiguous()
        # The ring's deposits are cropped away: a zero ring, no exchange.
        Gp = F.pad(G, (k, k, k, k))
        stn, gn = _cohort_advance(stp, auxp, Gp, rules, r, Llen, closure)
        return (self.crop_cf(stn, k).contiguous(),
                self.crop_cf(gn, k).contiguous())

    def _pass_overlap(self, st, G, aux, auxp, rules, r, Llen, closure, K):
        """Interior/boundary-band split. The r-round advance of the block
        interior (inset K) needs no fresh ring, so it runs while the x
        slabs are in flight; the four boundary bands (3K-wide strips: the
        K ring and 2K own cells) then advance with the arrived ring, and
        their valid K-wide frames replace the interior pass's frame. The
        x-bands span all columns and the y-bands all rows, so the corners
        are computed twice from identical inputs (either copy may win the
        paste). Each cell runs the same arithmetic as in `_pass_seq`."""
        bw, bh = st.shape[-2], st.shape[-1]
        pending = _post_axis(st, self.mesh, 0, st.dim() - 2, K)
        sti, gi = _cohort_advance(st, aux, G, rules, r, Llen, closure)
        stx = _finish_axis(st, pending, st.dim() - 2, 0.0, K)
        stp = exchange_axis(stx, self.mesh, 1, st.dim() - 1, 0.0, K)
        Gp = F.pad(G, (K, K, K, K))

        def band(rows, cols, vr, vc):
            stb, gb = _cohort_advance(
                stp[:, rows, cols].contiguous(),
                auxp[:, rows, cols].contiguous(),
                Gp[:, rows, cols].contiguous(), rules, r, Llen, closure)
            return stb[:, vr, vc], gb[:, vr, vc]

        full = slice(K, K + bh)
        xl = band(slice(0, 3 * K), slice(None), slice(K, 2 * K), full)
        xh = band(slice(bw - K, bw + 2 * K), slice(None), slice(K, 2 * K),
                  full)
        fullr = slice(K, K + bw)
        yl = band(slice(None), slice(0, 3 * K), fullr, slice(K, 2 * K))
        yh = band(slice(None), slice(bh - K, bh + 2 * K), fullr,
                  slice(K, 2 * K))

        def paste(i, interior):
            mid = torch.cat([yl[i][:, K:bw - K],
                             interior[:, K:bw - K, K:bh - K],
                             yh[i][:, K:bw - K]], dim=2)
            return torch.cat([xl[i], mid, xh[i]], dim=1).contiguous()

        return paste(0, sti), paste(1, gi)
