"""Linear upwind transport sweep: the plain torch rounds and the CUDA kernel
path (counterpart of `soillib_tpu/ops/sweep.py`).

The transport fixed point iterates G <- PUSH(att * (E + G)) for `iters`
rounds (ops/transport.py): per cell the payload att * (E + G) leaves
toward the two downwind neighbors in the ratio |vx| : |vy| of the cell's
unit direction, and what leaves the domain is lost (path.cu:104).

Two execution paths, chosen by the tensors' device:
  * CPU tensors: `transport_advance_reference`, one plain round at a time.
  * CUDA tensors: the hand-written Hopper kernel (csrc/transport_sweep.cu),
    up to SWEEP_K rounds per launch (trapezoid temporal blocking in shared
    memory, `sweep_launch_rounds`, `sweep_geometry`), held bitwise against
    the plain rounds on the card.

The JAX package caps the channel count of its TPU kernel
(`MAX_SWEEP_CHANNELS = 12`, a VMEM budget) and sends wider solves to the
plain rounds. The CUDA kernel loops over the channels inside a block and
keeps one channel's window on chip at a time, so this port has no cap:
every C goes through the kernel.

Gradients: the kernel has no reverse mode, so `run_transport` on the card
goes through `DiffableSweep`, whose backward replays the plain rounds
rematerialized per HALO_K-round block (`_advance_checkpointed`), as the
JAX package's custom_vjp does.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# Rounds per rematerialized block of the reverse pass (the JAX kernel's
# rounds per device-memory pass).
HALO_K = 16

# Kernel launches and the rounds they ran, counted where the wrapper
# launches the kernel and nowhere else.
sweep_launches = {"round": 0}
sweep_rounds = {"round": 0}

# Launch geometry, mirrored from csrc/transport_sweep.cu (SWEEP_K, TX, WY,
# CY, NTX, STAGED, BPS), which refuses any other: the most rounds one
# launch runs, which is also the recomputed ring; the owned tile (rows
# along x, columns along y); the window's columns; the columns of one
# thread (a warp spans the window's columns) and the threads along x;
# the fields staged in shared memory for the next tile and channel (G, E,
# att; vx, vy for channel 0); persistent blocks an SM.
SWEEP_K = 8
SWEEP_TILE = (32, 112)
SWEEP_WINDOW_COLS = 128
SWEEP_GROUP_COLS = 4
SWEEP_THREAD_ROWS = 16
SWEEP_STAGED = 5
SWEEP_BLOCKS_PER_SM = 1

# Shared memory a block may use on the H100 (227 KB).
MAX_SHARED_BYTES = 232_448


def _round_weights(vx, vy):
    """Loop-invariant outflow mask-weights: payload leaving toward
    +x/-x/+y/-y is payload * M_dir (|vx| : |vy| split)."""
    ax, ay = torch.abs(vx), torch.abs(vy)
    denom = ax + ay
    denom = torch.where(denom == 0.0, 1.0, denom)
    wx, wy = ax / denom, ay / denom
    z = torch.zeros_like(wx)
    return (
        torch.where(vx > 0, wx, z),
        torch.where(vx < 0, wx, z),
        torch.where(vy > 0, wy, z),
        torch.where(vy < 0, wy, z),
    )


def upwind_push_cf(payload, vx, vy):
    """One PUSH round, channel-first: the plain version of the kernel's
    round and the oracle it is held against."""
    mxp, mxn, myp, myn = _round_weights(vx, vy)

    def shift_from(a, dx, dy):
        # arriving[x, y] = a[x - dx, y - dy], zero inflow at the boundary;
        # F.pad takes last-dim pads first: (y_lo, y_hi, x_lo, x_hi).
        ap = F.pad(a, (max(0, dy), max(0, -dy), max(0, dx), max(0, -dx)))
        W, H = a.shape[-2], a.shape[-1]
        x0, y0 = max(0, -dx), max(0, -dy)
        return ap[..., x0:x0 + W, y0:y0 + H]

    return (
        shift_from(payload * mxp[None], +1, 0)
        + shift_from(payload * mxn[None], -1, 0)
        + shift_from(payload * myp[None], 0, +1)
        + shift_from(payload * myn[None], 0, -1)
    )


def transport_advance_reference(G0, E, att, vx, vy, iters: int):
    """Plain version of `transport_advance`: one pass per round."""
    G = G0
    for _ in range(int(iters)):
        G = upwind_push_cf(att * (E + G), vx, vy)
    return G


def transport_sweep_reference(E, att, vx, vy, iters: int):
    """Plain version of `transport_sweep`: the rounds from G = 0."""
    return transport_advance_reference(torch.zeros_like(E), E, att, vx, vy,
                                       iters)


def _advance_checkpointed(G0, E, att, vx, vy, iters: int):
    """`transport_advance_reference` rematerialized per HALO_K-round block:
    reverse mode stores only the block-boundary G states (iters/K of them)
    and recomputes each block's rounds in the backward pass, bounding the
    saved memory at O(C*W*H*(iters/K + K)) instead of O(C*W*H*iters)."""
    def blk(g, r):
        return checkpoint(
            lambda g_: transport_advance_reference(g_, E, att, vx, vy, r),
            g, use_reentrant=False)

    n_full, rem = divmod(int(iters), HALO_K)
    G = G0
    for _ in range(n_full):
        G = blk(G, HALO_K)
    if rem:
        G = blk(G, rem)
    return G


# ---------------------------------------------------------------------------
# CUDA kernel path (csrc/transport_sweep.cu)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepGeometry:
    """One launch of the sweep kernel: block and grid in CUDA's order (x
    along y, the contiguous axis), the tiles (along y, along x) that the
    grid's persistent blocks walk, the ring, rounds and dynamic shared
    memory bytes a block (the double-buffered payloads, the staged
    window of the next tile and channel, and its mbarrier)."""

    block: tuple
    grid: tuple
    tiles: tuple
    ring: int
    rounds: int
    smem: int


def sweep_launch_rounds(iters) -> list:
    """Rounds of each launch of an `iters`-round solve: SWEEP_K each, then
    one remainder launch of fewer."""
    n, rem = divmod(int(iters), SWEEP_K)
    return [SWEEP_K] * n + ([rem] if rem else [])


def sweep_geometry(C, W, H, rounds, sms=None) -> SweepGeometry:
    """The launch geometry of `rounds` rounds of C channels on a W x H
    grid: the tiles of SWEEP_TILE owned cells cover the domain, each
    loaded as a window with a SWEEP_K-cell ring; SWEEP_BLOCKS_PER_SM
    persistent blocks an SM (`sms` SMs; one block a tile when None or
    when there are fewer tiles) walk them. Shared memory does not grow
    with C (the channels loop inside the block)."""
    if not 1 <= int(rounds) <= SWEEP_K:
        raise ValueError(f"a sweep launch runs 1..{SWEEP_K} rounds, got "
                         f"{rounds}")
    if C < 1 or W < 1 or H < 1:
        raise ValueError(f"no sweep of shape ({C}, {W}, {H})")
    tx, ty = SWEEP_TILE
    tiles = (-(-H // ty), -(-W // tx))
    n = tiles[0] * tiles[1]
    window = (tx + 2 * SWEEP_K) * SWEEP_WINDOW_COLS
    return SweepGeometry((SWEEP_WINDOW_COLS // SWEEP_GROUP_COLS,
                          SWEEP_THREAD_ROWS),
                         (min(n, SWEEP_BLOCKS_PER_SM * sms) if sms else n,
                          1), tiles, SWEEP_K,
                         int(rounds), (2 + SWEEP_STAGED) * window * 4 + 8)


def _sweep_fn():
    """The built kernel's entry point (compiled from csrc/ at first use)."""
    from soillib_tpu_torch import _native

    fn = _native.load("transport_sweep").transport_rounds_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_sweep_inputs(G, E, att, vx, vy):
    """(C, W, H) of a kernel solve; raises on what the kernel cannot take
    (type, layout and shape first, then the device)."""
    for name, t, dim in (("G", G, 3), ("E", E, 3), ("att", att, 3),
                         ("vx", vx, 2), ("vy", vy, 2)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-d tensor, "
                             f"got shape {tuple(t.shape)}")
    C, W, H = E.shape
    if G.shape != E.shape or att.shape != E.shape:
        raise ValueError(f"G, E and att must share one (C, W, H) shape, got "
                         f"{tuple(G.shape)}, {tuple(E.shape)}, "
                         f"{tuple(att.shape)}")
    if vx.shape != (W, H) or vy.shape != (W, H):
        raise ValueError(f"vx and vy must be ({W}, {H})")
    for name, t in (("G", G), ("E", E), ("att", att), ("vx", vx),
                    ("vy", vy)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != E.device:
            raise ValueError("sweep inputs must share one device")
    return C, W, H


def transport_rounds_cuda(G, E, att, vx, vy, rounds, out):
    """`rounds` (1..SWEEP_K) rounds from G into `out` in ONE launch of the
    Hopper kernel; G is only read. Returns `out`."""
    C, W, H = _check_sweep_inputs(G, E, att, vx, vy)
    geo = sweep_geometry(C, W, H, rounds, torch.cuda.get_device_properties(
        E.device).multi_processor_count)
    if (out.shape != E.shape or out.dtype != torch.float32
            or not out.is_contiguous() or out.device != E.device
            or out.data_ptr() == G.data_ptr()):
        raise ValueError("out must be a distinct contiguous float32 tensor "
                         "like E")
    fn = _sweep_fn()
    stream = torch.cuda.current_stream(E.device).cuda_stream
    with torch.cuda.device(E.device):
        err = fn(G.data_ptr(), E.data_ptr(), att.data_ptr(), vx.data_ptr(),
                 vy.data_ptr(), out.data_ptr(), C, W, H, geo.rounds,
                 *geo.block, *geo.grid, geo.ring, geo.smem, stream)
    if err != 0:
        raise RuntimeError(f"transport_rounds kernel launch failed: CUDA "
                           f"error {err}")
    sweep_launches["round"] += 1
    sweep_rounds["round"] += geo.rounds
    return out


def transport_advance_cuda(G0, E, att, vx, vy, iters: int):
    """`iters` rounds on the card, up to SWEEP_K per launch
    (`sweep_launch_rounds`) with ping-pong buffers; the caller's G0 is
    only read."""
    _check_sweep_inputs(G0, E, att, vx, vy)
    split = sweep_launch_rounds(iters)
    G = G0
    bufs = [torch.empty_like(E),
            torch.empty_like(E) if len(split) > 1 else None]
    for j, n in enumerate(split):
        G = transport_rounds_cuda(G, E, att, vx, vy, n, bufs[j % 2])
    return G.clone() if G is G0 else G


def transport_advance(G0, E, att, vx, vy, iters: int):
    """`iters` rounds of G <- PUSH(att * (E + G)) from an arbitrary G0.

    Args:
      G0:   (C, W, H) initial inflow state (zeros for a fresh solve).
      E:    (C, W, H) per-cell emission (channel-first).
      att:  (C, W, H) per-cell, per-channel attenuation.
      vx, vy: (W, H) unit flow direction components.
    Returns:
      (C, W, H) accumulated inflow G. CUDA tensors launch the kernel
      (up to SWEEP_K rounds a launch); CPU tensors run the plain rounds.
    """
    if E.device.type == "cuda":
        return transport_advance_cuda(G0, E, att, vx, vy, iters)
    if E.device.type != "cpu":
        raise ValueError(f"no transport sweep for device {E.device}")
    return transport_advance_reference(G0, E, att, vx, vy, iters)


def transport_sweep(E, att, vx, vy, iters: int):
    """`iters` rounds of G <- PUSH(att * (E + G)) from G = 0."""
    return transport_advance(torch.zeros_like(E), E, att, vx, vy, iters)


def _vjp_checkpointed(inputs, ct, fn):
    """Cotangents of `inputs` under fn(*inputs) = the checkpointed plain
    rounds, for the output cotangent ct."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, ct, allow_unused=True)


class DiffableSweep(torch.autograd.Function):
    """`transport_sweep` (the kernel on the card) with a plain reverse
    pass: the backward replays the (mathematically identical) plain rounds,
    checkpointed per HALO_K-round block."""

    @staticmethod
    def forward(ctx, E, att, vx, vy, iters):
        ctx.iters = int(iters)
        ctx.save_for_backward(E, att, vx, vy)
        return transport_sweep(E, att, vx, vy, iters)

    @staticmethod
    def backward(ctx, ct):
        iters = ctx.iters
        grads = _vjp_checkpointed(
            ctx.saved_tensors, ct,
            lambda e, a, x, y: _advance_checkpointed(
                torch.zeros_like(e), e, a, x, y, iters))
        return (*grads, None)


class DiffableAdvance(torch.autograd.Function):
    """`transport_advance` with a plain reverse pass (see DiffableSweep)."""

    @staticmethod
    def forward(ctx, G0, E, att, vx, vy, iters):
        ctx.iters = int(iters)
        ctx.save_for_backward(G0, E, att, vx, vy)
        return transport_advance(G0, E, att, vx, vy, iters)

    @staticmethod
    def backward(ctx, ct):
        iters = ctx.iters
        grads = _vjp_checkpointed(
            ctx.saved_tensors, ct,
            lambda g, e, a, x, y: _advance_checkpointed(g, e, a, x, y,
                                                        iters))
        return (*grads, None)


def run_transport(E, att, vx, vy, iters: int):
    """Device-dispatched `iters`-round transport solve (channel-first):
    CUDA tensors launch the kernel (reverse mode through DiffableSweep),
    CPU tensors run the plain rounds."""
    if E.device.type == "cuda":
        return DiffableSweep.apply(E.contiguous(), att.contiguous(),
                                   vx.contiguous(), vy.contiguous(),
                                   int(iters))
    if E.device.type != "cpu":
        raise ValueError(f"no transport sweep for device {E.device}")
    return transport_sweep_reference(E, att, vx, vy, iters)
