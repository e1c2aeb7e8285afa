"""The rank mesh, field placement and the launcher for 2-D domain
decomposition on `torch.distributed` (counterpart of
`soillib_tpu/parallel/mesh.py`).

A (W, H) field is block-decomposed over a px x py mesh of ranks with axis
names ("X", "Y"): axis 0 of every field is split over "X" and axis 1 over
"Y", channel dims stay whole. One process runs each block and all run the
same code (SPMD, as the JAX package's `shard_map`). Rank r sits at mesh
coordinate (r // py, r % py), the row-major order of the JAX package's
`make_mesh`.

The transport is named by the caller, never picked:

* "nccl": one rank per card, CUDA tensors sent as they are (the multi-card
  path). NCCL refuses two ranks on one card, so such a request raises.
* "gloo": CPU tensors, or CUDA tensors staged through pinned host memory
  when several ranks share one card (every compute op stays on the card).

Three ways to get a mesh:

* `launch(fn, nprocs, devices=..., transport=...)` spawns the ranks on
  this host (their group meets through a file store) and calls
  fn(mesh, *args) in each (the counterpart of the JAX examples' virtual
  devices and of `jax.distributed`);
* under `torchrun`, `make_mesh(transport=...)` reads RANK, WORLD_SIZE and
  LOCAL_RANK and joins the group;
* in a plain process, `make_mesh()` is a 1 x 1 mesh with no group: every
  halo fill hits the domain boundary and nothing is exchanged.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from soillib_tpu_torch.core.device import _device

AXES = ("X", "Y")
TRANSPORTS = ("nccl", "gloo")

# Seconds a collective or a neighbour exchange may wait before the process
# group raises (so one failed rank cannot leave the others waiting).
DEFAULT_TIMEOUT = 600.0


def factor2(n: int) -> tuple:
    """Most-square (px, py) factorization of n, px * py == n, px <= py."""
    px = int(math.isqrt(n))
    while n % px != 0:
        px -= 1
    return (px, n // px)


class Mesh:
    """This rank's view of a px x py block mesh.

    Attributes:
      shape: (px, py) block counts.
      rank: this process's rank; coord: its (cx, cy) mesh coordinate.
      device: where this rank's blocks live.
      transport: "nccl", "gloo" or None (a 1 x 1 mesh without a group).
      axis_names: ("X", "Y").
    """

    def __init__(self, shape, rank, device, transport, axis_names=AXES):
        self.shape = (int(shape[0]), int(shape[1]))
        self.rank = int(rank)
        self.coord = (self.rank // self.shape[1], self.rank % self.shape[1])
        self.device = torch.device(device)
        self.transport = transport
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def distributed(self) -> bool:
        """True when the mesh has a process group (collectives run)."""
        return self.transport is not None

    @property
    def host_staged(self) -> bool:
        """Gloo with blocks on the card: exchanges go through host memory."""
        return self.transport == "gloo" and self.device.type == "cuda"

    @property
    def transport_name(self) -> str:
        if self.transport is None:
            return "none (1 x 1, no group)"
        return "gloo, host-staged" if self.host_staged else self.transport

    def neighbor(self, axis: int, step: int):
        """Rank of the block `step` (+1 or -1) along mesh axis `axis`, or
        None past the domain edge (the shifts do not wrap)."""
        c = list(self.coord)
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return c[0] * self.shape[1] + c[1]

    def all_reduce(self, t):
        """Sum of `t` over the mesh, on every rank (in place on gloo/nccl
        groups; a tensor on the card goes through host memory on gloo)."""
        if not self.distributed:
            return t
        if self.host_staged:
            h = t.detach().cpu()
            dist.all_reduce(h)
            return h.to(t.device)
        dist.all_reduce(t)
        return t

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"coord={self.coord}, device={self.device}, "
                f"transport={self.transport_name!r})")


def _check_transport(transport, device):
    if (device.type == "cuda"
            and (device.index or 0) >= torch.cuda.device_count()):
        raise ValueError(f"{device} does not exist: "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                         f"{transport!r}")
    if transport == "nccl" and device.type != "cuda":
        raise ValueError("the nccl transport sends CUDA tensors; give each "
                         "rank a card, or use transport='gloo' for CPU ranks")


def _check_nccl_devices(devices):
    """NCCL takes one card per rank on a host: two ranks on one card
    raise here rather than fail inside NCCL."""
    idx = [torch.device(d) for d in devices]
    seen = {(d.type, d.index or 0) for d in idx}
    if len(seen) < len(idx):
        raise ValueError(
            f"the nccl transport needs one card per rank; {len(idx)} ranks "
            f"were given {len(seen)} distinct device(s). Ranks that share a "
            f"card need transport='gloo' (host-staged exchanges)")


def make_mesh(shape=None, devices=None, transport=None, axis_names=AXES,
              timeout=DEFAULT_TIMEOUT) -> Mesh:
    """This rank's 2-D mesh over the process group.

    In a process of a group (the launcher's ranks, or a `torchrun` world,
    which this call joins), the mesh spans its world: `shape=None` picks
    the most-square factorization of the world size. `devices`, one per
    rank, places the blocks (default: the card of the local rank);
    `transport` names the group's backend and must agree with it. In a
    plain process the mesh is 1 x 1 on `devices[0]` (default the card),
    with no group."""
    env = os.environ
    if not dist.is_initialized() and "RANK" in env and "WORLD_SIZE" in env:
        if transport is None:
            raise ValueError("under torchrun, name the transport: "
                             "make_mesh(transport='nccl' or 'gloo')")
        local = int(env.get("LOCAL_RANK", 0))
        dev = _device(devices[int(env["RANK"])] if devices is not None
                      else f"cuda:{local}")
        _check_transport(transport, dev)
        if transport == "nccl":
            nlocal = int(env.get("LOCAL_WORLD_SIZE", 1))
            if nlocal > torch.cuda.device_count():
                raise ValueError(
                    f"the nccl transport needs one card per rank; {nlocal} "
                    f"local ranks, {torch.cuda.device_count()} cards")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            transport, timeout=datetime.timedelta(seconds=timeout))
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = str(dist.get_backend())
        if transport is not None and transport != backend:
            raise ValueError(f"the process group runs {backend!r}, not the "
                             f"requested transport {transport!r}")
        if devices is not None:
            dev = _device(devices[rank])
        else:
            dev = _device(f"cuda:{int(env.get('LOCAL_RANK', 0))}")
        _check_transport(backend, dev)
    else:
        if transport is not None:
            raise ValueError(f"transport {transport!r} needs a process group: "
                             f"run under `launch` or torchrun")
        world, rank, backend = 1, 0, None
        dev = _device(devices[0] if devices is not None else "cuda")
    if shape is None:
        shape = factor2(world)
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {tuple(shape)} != {world} ranks")
    mesh = Mesh(shape, rank, dev, backend, axis_names)
    if backend == "nccl":
        # The first collective sets up the communicator on every rank.
        mesh.all_reduce(torch.zeros(1, device=dev))
    return mesh


def check_divisible(shape, mesh: Mesh, radius: int = 1):
    """Validate that (W, H) splits evenly and blocks are at least `radius`
    wide (a halo exchange only reaches the adjacent block)."""
    px, py = mesh.shape
    W, H = int(shape[0]), int(shape[1])
    if W % px or H % py:
        raise ValueError(f"grid {W}x{H} not divisible by mesh {px}x{py}")
    if W // px < radius or H // py < radius:
        raise ValueError(
            f"blocks {W // px}x{H // py} smaller than halo radius {radius}"
        )


# ---------------------------------------------------------------------------
# Placement: which leaves split, a global field -> this rank's block, and
# back
# ---------------------------------------------------------------------------


def leaf_spec(arr, mesh: Mesh = None) -> tuple:
    """How a field splits: (W, H) over both mesh axes ("X", "Y");
    channel-first (C, W, H) keeps C whole (None, "X", "Y"); broadcastable
    (..., 1, 1) constant fields (see ErosionState.zeros) are replicated
    (())."""
    shape = tuple(arr.shape)
    if shape[-2:] == (1, 1):
        return ()
    if len(shape) == 2:
        return AXES
    return (None,) * (len(shape) - 2) + AXES


def _map_leaves(fn, tree):
    """fn over the tensor/array leaves of a dataclass, tuple, list or dict
    (the state pytrees of this package)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def state_specs(state, mesh: Mesh = None):
    """The `leaf_spec` of every leaf of a state pytree."""
    return _map_leaves(leaf_spec, state)


def block_slices(shape, mesh: Mesh):
    """(x slice, y slice) of this rank's block in a global (W, H) grid."""
    check_divisible(shape, mesh)
    bw, bh = int(shape[0]) // mesh.shape[0], int(shape[1]) // mesh.shape[1]
    cx, cy = mesh.coord
    return slice(cx * bw, (cx + 1) * bw), slice(cy * bh, (cy + 1) * bh)


def _split_dims(t, spec):
    """The tensor dims split over "X" and "Y" by `spec` (default
    `leaf_spec`), or None for a replicated leaf."""
    spec = leaf_spec(t) if spec is None else tuple(spec)
    if not spec:
        return None
    return spec.index(AXES[0]), spec.index(AXES[1])


def shard_field(arr, mesh: Mesh, spec=None):
    """This rank's block of a global field (numpy or tensor), contiguous
    on the mesh's device. `spec` says which dims split (`leaf_spec`'s
    rule by default: (W, H) and channel-first (C, W, H) split their last
    two dims, a (..., 1, 1) constant field is kept whole); a channel-last
    (W, H, C) ops-layer field takes spec=("X", "Y", None)."""
    t = (arr if isinstance(arr, torch.Tensor)
         else torch.as_tensor(np.ascontiguousarray(arr)))
    dims = _split_dims(t, spec)
    if dims is not None:
        sx, sy = block_slices((t.shape[dims[0]], t.shape[dims[1]]), mesh)
        t = t.narrow(dims[0], sx.start, sx.stop - sx.start).narrow(
            dims[1], sy.start, sy.stop - sy.start)
    return t.to(mesh.device).contiguous()


def shard_state(state, mesh: Mesh):
    """`shard_field` of every leaf of a state pytree (e.g. ErosionState)."""
    return _map_leaves(lambda a: shard_field(a, mesh), state)


# Every process holds the global field here and takes its own block, so
# the pod form (each process contributing only its addressable shards in
# the JAX package) is the same function.
shard_field_global = shard_field
shard_state_global = shard_state


def gather_field(block, mesh: Mesh, everywhere: bool = False, spec=None):
    """The inverse of `shard_field`: rank 0 (every rank with
    `everywhere`) gets the global field on its device, the other ranks
    None. A replicated leaf comes back as it is. Every rank of the mesh
    must call it."""
    dims = _split_dims(block, spec)
    if dims is None or not mesh.distributed:
        return block if everywhere or mesh.rank == 0 else None
    t = block.detach().contiguous()
    send = t.cpu() if mesh.transport == "gloo" else t
    if everywhere:
        parts = [torch.empty_like(send) for _ in range(mesh.size)]
        dist.all_gather(parts, send)
    else:
        parts = ([torch.empty_like(send) for _ in range(mesh.size)]
                 if mesh.rank == 0 else None)
        dist.gather(send, parts, dst=0)
        if mesh.rank != 0:
            return None
    bw, bh = t.shape[dims[0]], t.shape[dims[1]]
    shape = list(t.shape)
    shape[dims[0]] *= mesh.shape[0]
    shape[dims[1]] *= mesh.shape[1]
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    for r, p in enumerate(parts):
        cx, cy = r // mesh.shape[1], r % mesh.shape[1]
        out.narrow(dims[0], cx * bw, bw).narrow(dims[1], cy * bh, bh).copy_(
            p.to(t.device))
    return out


def gather_state(state, mesh: Mesh, everywhere: bool = False):
    """`gather_field` of every leaf of a state pytree (None off rank 0
    unless `everywhere`)."""
    out = _map_leaves(lambda a: gather_field(a, mesh, everywhere), state)
    return out if everywhere or mesh.rank == 0 else None


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _rank_main(rank, nprocs, devices, transport, shape, timeout, outdir):
    """A spawned rank: join the group, build the mesh, run fn(mesh, *args)
    (read from the launcher's file) and save what it returns for the
    launcher."""
    dev = _device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # The CPU ranks share the host's cores: one thread each.
        torch.set_num_threads(1)
    # A file store in the launch's own directory: no port to pick, so
    # concurrent launches on one host cannot collide.
    dist.init_process_group(
        transport, init_method="file://" + os.path.join(outdir, "store"),
        rank=rank, world_size=nprocs,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        fn, args = torch.load(os.path.join(outdir, "call.pt"),
                              weights_only=False)
        mesh = make_mesh(shape, devices=devices, transport=transport)
        out = fn(mesh, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        torch.save(out, os.path.join(outdir, f"{rank}.pt"))
    except BaseException:
        # For the launcher's report: the first rank to fail is the cause,
        # the others mostly see its connection close.
        with open(os.path.join(outdir, f"{rank}.err"), "w") as f:
            f.write(f"{time.time():.6f}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _rank_errors(outdir, nprocs) -> str:
    """The tracebacks the ranks left, the first to fail first."""
    errs = []
    for r in range(nprocs):
        path = os.path.join(outdir, f"{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                stamp, _, text = f.read().partition("\n")
            errs.append((float(stamp), r, text))
    if not errs:
        return f"{nprocs} ranks: a rank failed without a traceback"
    return "\n".join(f"--- rank {r} ---\n{text}" for _, r, text in
                     sorted(errs))


def launch(fn, nprocs: int, *, transport: str, devices=None, args=(),
           shape=None, timeout=DEFAULT_TIMEOUT):
    """Run fn(mesh, *args) on `nprocs` spawned ranks and return the list of
    what each rank's fn returned (tensors come back on the CPU).

    `devices` gives each rank its device (default: a card each for nccl,
    the one card shared for gloo); `transport` is "nccl" or "gloo" and is
    never changed: NCCL with two ranks on one card raises. `fn` must be
    importable by name (a module-level function): the ranks are spawned
    processes. A rank that raises, or a run that outlasts `timeout`
    seconds, makes the launcher raise; the other ranks are stopped."""
    import torch.multiprocessing as tmp

    nprocs = int(nprocs)
    if devices is None:
        devices = ([f"cuda:{i}" for i in range(nprocs)]
                   if transport == "nccl" else ["cuda"] * nprocs)
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"{nprocs} ranks need {nprocs} devices, got "
                         f"{len(devices)}")
    for d in devices:
        _check_transport(transport, _device(d))
    if transport == "nccl":
        _check_nccl_devices(devices)
    if any(torch.device(d).type == "cuda" for d in devices):
        # Build the kernels once here, so the ranks only load them.
        from soillib_tpu_torch import _native

        _native.build()
    with tempfile.TemporaryDirectory(prefix="soil_launch_") as outdir:
        # The call goes through a file: arguments sent down the spawn pipe
        # hold each start until the previous rank has imported its
        # modules.
        torch.save((fn, tuple(args)), os.path.join(outdir, "call.pt"))
        ctx = tmp.start_processes(
            _rank_main,
            args=(nprocs, devices, transport, shape, timeout, outdir),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        if p.is_alive():
                            p.kill()
                    for p in ctx.processes:
                        p.join()
                    raise TimeoutError(f"{nprocs} ranks did not finish "
                                       f"within {timeout} s")
        except Exception as e:
            raise RuntimeError(_rank_errors(outdir, nprocs)) from e
        return [torch.load(os.path.join(outdir, f"{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(nprocs)]
