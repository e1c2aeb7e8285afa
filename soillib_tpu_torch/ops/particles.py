"""The erosion particle estimators' trajectory loop on the card: the wrapper
of csrc/particle_rounds.cu.

`particle_rounds_cuda` runs what models/erosion.py `_particle_rounds_plain`
runs (the plain loop, the CPU path and the tests' reference) in one launch
of the hand-written kernel: one thread a particle, every round in
registers, deposits added into the cell-major flux with atomics. The
physics comes from the estimator's `advance` object
(models/erosion.py `FluvialAdvance`, `DebrisAdvance`): its `kind` picks the
kernel, `kernel_scalars()` gives its constants and `lookups` its per-cell
fields, of which the wrapper packs (gx, gy, mx, my) into one 16-byte
entry a cell. The kernel adds into a cell-major flux padded to FLUX_ROW
floats a cell; the wrapper returns its first C channels.

Under `torch.use_deterministic_algorithms(True)` the atomics' order would
make two runs differ in the last bits, so the wrapper then launches the
kernel once a round with a log of each particle's cell and deposits, and
adds the log with torch's deterministic `index_add_`: the same trajectories,
a fixed summation order.

Counters: `particle_launches`, the kernel's launches by kind (host
ints, in core/graphs.py `launch_counters`, so a captured step's replays
add what its capture launched), and the live particle-rounds the kernel
ran (a particle is live in a round that it starts in bounds and alive),
which the kernel adds on the card into a counter of its own module on
each device, eager and captured launches alike: no call waits to read
it, and no tensor holds it. `particle_rounds()` reads it (summed over the
devices) and `reset_particle_rounds()` sets it to 0. It counts every
launch that ran, a CapturedStep's eager warm-up included.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from soillib_tpu_torch.ops.transport import _f32

_KINDS = {"fluvial": 0, "debris": 1}

particle_launches = dict.fromkeys(_KINDS, 0)
# The devices the kernel ran on (indices): each holds its live
# particle-rounds in the kernel's module.
_devices = set()


def particle_rounds() -> dict:
    """The live particle-rounds the kernel ran since the last
    `reset_particle_rounds()`, by kind, summed over the devices. Waits for
    the devices' work."""
    out = dict.fromkeys(_KINDS, 0)
    for d in sorted(_devices):
        n = (ctypes.c_ulonglong * len(_KINDS))()
        with torch.cuda.device(d):
            _raise_on(_lib().particle_rounds_read(n), "read")
        for kind, i in _KINDS.items():
            out[kind] += n[i]
    return out


def reset_particle_rounds() -> None:
    """Sets the live particle-rounds of every device to 0."""
    for d in sorted(_devices):
        with torch.cuda.device(d):
            _raise_on(_lib().particle_rounds_reset(), "reset")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"particle kernel {what} failed: CUDA error {err}")


class _Params(ctypes.Structure):
    _fields_ = [("W", ctypes.c_int), ("H", ctypes.c_int),
                ("N", ctypes.c_int), ("rounds", ctypes.c_int),
                ("bx", ctypes.c_float), ("by", ctypes.c_float),
                ("llen", ctypes.c_float), ("r", ctypes.c_float * 8)]


_ARRAYS = ("px", "py", "ind", "spx", "spy", "alive", "att", "src", "cell4",
           "dis", "flux", "log_ind", "log_val")
# The flux's channels in the kernel's layout: each cell's row padded to 8
# floats (32 B), two 16-byte vector reductions a deposit.
FLUX_ROW = 8


class _Arrays(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _ARRAYS]


@functools.lru_cache(maxsize=None)
def _lib():
    from soillib_tpu_torch import _native

    lib = _native.load("particle_rounds")
    lib.particle_rounds_launch.argtypes = [
        ctypes.c_int, ctypes.POINTER(_Params), ctypes.POINTER(_Arrays),
        ctypes.c_void_p]
    lib.particle_rounds_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.particle_rounds_reset.argtypes = []
    for fn in (lib.particle_rounds_launch, lib.particle_rounds_read,
               lib.particle_rounds_reset):
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")


def particle_rounds_cuda(W, H, rounds, px, py, ind, spx, spy, alive, src,
                         att, Llen, advance):
    """`rounds` rounds of the trajectory loop for the N particles of
    (px, py, ind, spx, spy, alive) (N) with attenuations `att` (A, N) and
    sources `src` (C, N), on the card: one launch (one a round under
    deterministic algorithms). Returns the flux (C, W*H), a channel-first
    view of the cell-major flux, as `_particle_rounds_plain` does. The
    particles' tensors are only read."""
    kind = getattr(advance, "kind", None)
    if kind not in _KINDS:
        raise NotImplementedError(
            f"the particle kernel runs the fluvial and debris estimators of "
            f"this package only; got an advance of kind {kind!r}")
    C, A = len(advance.sel), max(advance.sel) + 1
    N = px.shape[0]
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"the particle kernel takes CUDA tensors, got {dev}")
    if N == 0:
        raise ValueError("the particle kernel needs at least one particle")
    f32 = torch.float32
    for name, t in (("px", px), ("py", py), ("spx", spx), ("spy", spy)):
        _check(name, t, f32, (N,), dev)
    _check("ind", ind, torch.int64, (N,), dev)
    _check("alive", alive, torch.bool, (N,), dev)
    _check("att", att, f32, (A, N), dev)
    _check("src", src, f32, (C, N), dev)
    if len(advance.lookups) != (5 if kind == "fluvial" else 4):
        raise ValueError(f"the {kind} kernel reads "
                         f"{5 if kind == 'fluvial' else 4} per-cell fields, "
                         f"the advance has {len(advance.lookups)}")
    for name, t in zip(("gx", "gy", "mx", "my", "dis"), advance.lookups):
        _check(name, t, f32, (W * H,), dev)
    cell4 = torch.stack(advance.lookups[:4], dim=1)
    dis = advance.lookups[4].contiguous() if kind == "fluvial" else None

    state = {"px": px, "py": py, "ind": ind, "spx": spx, "spy": spy,
             "alive": alive, "att": att}
    deterministic = torch.are_deterministic_algorithms_enabled()
    if deterministic:
        # One round a launch writes the state back: into copies.
        state = {k: v.clone(memory_format=torch.contiguous_format)
                 for k, v in state.items()}
    else:
        state = {k: v.contiguous() for k, v in state.items()}
    src = src.contiguous()
    flux = torch.zeros((W * H, C if deterministic else FLUX_ROW), dtype=f32,
                       device=dev)
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    ptrs.update(src=src.data_ptr(), cell4=cell4.data_ptr(),
                dis=None if dis is None else dis.data_ptr(),
                flux=flux.data_ptr())
    params = _Params(int(W), int(H), int(N), int(rounds),
                     _f32(W - 1e-3), _f32(H - 1e-3), float(Llen),
                     (ctypes.c_float * 8)(*advance.kernel_scalars()))
    fn = _lib().particle_rounds_launch
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(arrays):
        with torch.cuda.device(dev):
            err = fn(_KINDS[kind], ctypes.byref(params),
                     ctypes.byref(arrays), stream)
        _raise_on(err, "launch")
        particle_launches[kind] += 1
        _devices.add(dev.index)

    if deterministic:
        # The log's rounds add into an unpadded flux.
        log_ind = torch.empty((N,), dtype=torch.int64, device=dev)
        log_val = torch.empty((N, C), dtype=f32, device=dev)
        arrays = _Arrays(**ptrs, log_ind=log_ind.data_ptr(),
                         log_val=log_val.data_ptr())
        params.rounds = 1
        for _ in range(int(rounds)):
            launch(arrays)
            flux.index_add_(0, log_ind, log_val)
    else:
        launch(_Arrays(**ptrs))
    return flux[:, :C].T
