"""A step of fixed shapes, captured once as a CUDA graph and replayed: the
port's counterpart of the JAX package's `jax.jit` over `lax.fori_loop`
(`soillib_tpu/models/simulation.py` `_compiled_step`).

`CapturedStep(step, fields)` owns static buffers, one for each field of
the state, made from `fields`. `step(fields, generator)` is a function of
torch ops that returns the next fields (same names, same shapes). On a
CUDA state the step is run once eagerly on a side stream (the warm-up:
it loads every kernel library and makes every cached constant), then
captured once with `torch.cuda.CUDAGraph` under `torch.no_grad()`,
followed inside the graph by in-place copies of its outputs into the
static buffers. One replay is one step; n replays are n steps. On a CPU
state the same object runs the step eagerly, with the same buffers, the
same copies and the same donation rules, so the tests reach it.

What cannot be captured raises, with the cause, at capture or at replay:
a read of a device value on the host (`.item()`, `bool(tensor)`), a copy
from host memory, a generator that is not registered. Nothing falls back
to eager code.

The kernel wrappers count their launches in plain dicts
(`launch_counters`). A captured launch is counted once, at capture; the
capture records each counter's change, the counters are put back to what
they were before the warm-up, and each replay adds the recorded change.
Where the device decides what runs (the cohort solve's adaptive exit:
the launches after it do nothing), the wrapper reports the device's
count (`count_on_device`); the replays sum it on the card, and the call
reads the sum once at its end.

Every capture adds its warm-up, capture and instantiation seconds to one
record of the process (`graph_setup`). The capture puts the phase marks
`step_begin` at its head and `step_end` at its end (`core/trace.py`; the
step itself marks the boundaries between its phases), and a call enters
the driver's host spans while a profiler runs.
"""

from __future__ import annotations

import contextlib
import time
import weakref

import torch

from soillib_tpu_torch.core.trace import mark, prepare_marks, span


def launch_counters() -> tuple:
    """The launch and round counters of the port's kernel wrappers (dicts
    of ints, changed in place)."""
    from soillib_tpu_torch.ops import cohort, graph_tiled, particles, sweep

    return (cohort.cohort_round_launches, cohort.cohort_rounds,
            sweep.sweep_launches, sweep.sweep_rounds, graph_tiled.tile_launches,
            particles.particle_launches)


# Host seconds of the set-up of every CapturedStep captured in the process.
_setup = {"steps": 0, "warmup_s": 0.0, "capture_s": 0.0,
          "instantiate_s": 0.0}


def graph_setup() -> dict:
    """The process's record of graph set-up: `steps`, the CapturedSteps
    captured so far, and the host seconds of their warm-up steps, captures
    and instantiations (`warmup_s`, `capture_s`, `instantiate_s`), each
    summed over them. A copy."""
    return dict(_setup)


# Counts that only the device knows. Under a CapturedStep's capture a
# wrapper whose launches do work or not by device data (the cohort solve's
# adaptive exit) reports here, for each counter it bumped on the host:
# (counter dict, key, what it added, a 0-dim int32 device tensor of what
# ran). Each replay then adds the device count in place of the host's,
# into a sum on the card of at most DEVICE_COUNTS entries.
_device_counts = None
DEVICE_COUNTS = 256


def count_on_device(counts: dict, key, host_n: int, device_n):
    """Report that `host_n` of what the wrapper just added to
    counts[key] at capture is really `device_n` (a device tensor); outside
    a CapturedStep's capture there is nothing to report to."""
    if _device_counts is not None:
        _device_counts.append((counts, key, int(host_n), device_n))


def _snapshot():
    return [dict(c) for c in launch_counters()]


def _restore(saved):
    for counts, before in zip(launch_counters(), saved):
        counts.clear()
        counts.update(before)


def _write_back(static: dict, out: dict):
    """Copies each output field into its static buffer. An output that is
    its own buffer is left alone; one that shares memory with another
    buffer (a pass-through of an input field) is cloned before any buffer
    is written, so every copy reads the step's values."""
    storages = {s.untyped_storage().data_ptr() for s in static.values()}
    pending = {}
    for name, t in out.items():
        s = static[name]
        if t is s:
            continue
        if t.shape != s.shape or t.dtype != s.dtype:
            raise RuntimeError(
                f"the step returned {name} as {tuple(t.shape)} "
                f"{t.dtype}, its buffer is {tuple(s.shape)} {s.dtype}: a "
                f"captured step keeps every field's shape")
        if t.untyped_storage().data_ptr() in storages:
            t = t.clone()
        pending[name] = t
    for name, t in pending.items():
        static[name].copy_(t)


class CapturedStep:
    """One step over static buffers (see the module docstring), replayed
    from a CUDA graph on the card and run eagerly on the CPU.

    `pool`: a `torch.cuda.graph_pool_handle()` that the graph's
    temporaries come from; steps that share one are replayed one at a
    time (on one stream), and their memory is that of the largest, not
    the sum.

    Attributes (None on the CPU): `warmup_s`, `capture_s` and
    `instantiate_s`, host seconds of the warm-up step, of the capture and
    of the graph's instantiation; `launch_delta`, the counters' change
    that one replay adds; `generator`, the generator the graph draws from
    (registered with it), when the step draws."""

    def __init__(self, step, fields: dict, draws: bool = False, pool=None):
        self.step = step
        self.pool = pool
        first = next(iter(fields.values()))
        self.device = first.device
        # Made outside the graph's pool: they outlive the graph, and a
        # donated state is these tensors.
        self.static = {
            k: torch.empty_like(v, memory_format=torch.contiguous_format)
            for k, v in fields.items()}
        self.generator = (torch.Generator(device=self.device) if draws
                          else None)
        self.graph = None
        self.warmup_s = self.capture_s = self.instantiate_s = None
        self.launch_delta = None
        self._device_sum = None
        self._device_keys = []
        self._handed = {}
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._copy_in(fields)
                self._capture()
        elif self.device.type != "cpu":
            raise ValueError(f"no captured step for device {self.device}")

    def _capture(self):
        dev = self.device
        saved = _snapshot()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.no_grad(), torch.cuda.stream(side):
            self.step(dict(self.static), self.generator)
        torch.cuda.current_stream(dev).wait_stream(side)
        prepare_marks(dev)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0
        _restore(saved)

        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        global _device_counts
        _device_counts = reported = []
        # Outside the pool: no tensor of the pool outlives the capture, so
        # graphs may share one pool (replayed one at a time).
        device_sum = torch.zeros(DEVICE_COUNTS, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=self.pool):
                mark("step_begin")
                _write_back(self.static,
                            self.step(dict(self.static), self.generator))
                if len(reported) > DEVICE_COUNTS:
                    raise RuntimeError(f"a step reports {len(reported)} "
                                       f"device counts, at most "
                                       f"{DEVICE_COUNTS}")
                if reported:
                    device_sum[:len(reported)].add_(
                        torch.stack([r[3] for r in reported]))
                mark("step_end")
        except BaseException:
            _restore(saved)
            raise
        finally:
            _device_counts = None
        self.capture_s = time.perf_counter() - t0
        after = _snapshot()
        _restore(saved)
        # By identity: two counters may hold equal counts.
        index = {id(c): i for i, c in enumerate(launch_counters())}
        for counts, key, host_n, _ in reported:
            after[index[id(counts)]][key] -= host_n
        self.launch_delta = [
            {k: n - before.get(k, 0) for k, n in now.items()
             if n != before.get(k, 0)}
            for now, before in zip(after, saved)]
        self._device_keys = [(index[id(c)], k) for c, k, _, _ in reported]
        self._device_sum = device_sum[:len(reported)] if reported else None
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.instantiate_s = time.perf_counter() - t0
        self.graph = graph
        _setup["steps"] += 1
        for k in ("warmup_s", "capture_s", "instantiate_s"):
            _setup[k] += getattr(self, k)

    def _copy_in(self, fields: dict):
        """The caller's fields into the buffers. A field that is its
        buffer (a state returned with donation), or the copy of it this
        object returned last, unchanged since (by torch's version
        counters) while the buffer is unchanged too, is not copied. A
        compact field broadcasts into a full-size buffer."""
        for name, t in fields.items():
            s = self.static[name]
            ref, version, static_version = self._handed.get(
                name, (None, None, None))
            if t is s or (ref is not None and ref() is t
                          and t._version == version
                          and s._version == static_version):
                continue
            s.copy_(t)

    def __call__(self, fields: dict, steps: int, generator=None,
                 donate: bool = False) -> dict:
        """`steps` steps from `fields`. `generator` (when the step draws)
        is the caller's: the step draws as if from it, and it advances as
        the eager steps would advance it. donate=False returns fresh
        tensors that later calls never touch; donate=True returns the
        buffers themselves, which the next call overwrites. Either way a
        caller that hands back what it got is not copied in
        (`_copy_in`)."""
        if self.generator is not None and (
                generator is None
                or generator.device.type != self.device.type):
            raise ValueError(
                f"this step draws from a generator on {self.device}; got "
                f"{generator if generator is None else generator.device}")
        on_card = (torch.cuda.device(self.device) if self.graph is not None
                   else contextlib.nullcontext())
        with torch.no_grad(), on_card:
            with span("soil.step.copy_in"):
                self._copy_in(fields)
                if self.generator is not None:
                    self.generator.set_state(generator.get_state())
            with span("soil.step.replay"):
                if self.graph is not None:
                    for _ in range(int(steps)):
                        self.graph.replay()
                        for counts, delta in zip(launch_counters(),
                                                 self.launch_delta):
                            for k, n in delta.items():
                                counts[k] = counts.get(k, 0) + n
                else:
                    for _ in range(int(steps)):
                        _write_back(self.static, self.step(
                            dict(self.static), self.generator))
            if self._device_sum is not None:
                # One read of the device's counts a call.
                with span("soil.step.read_counts"):
                    for (i, k), n in zip(self._device_keys,
                                         self._device_sum.tolist()):
                        counts = launch_counters()[i]
                        counts[k] = counts.get(k, 0) + n
                    self._device_sum.zero_()
            if self.generator is not None:
                generator.set_state(self.generator.get_state())
            if donate:
                self._handed = {}
                return dict(self.static)
            with span("soil.step.clone_out"):
                out = {k: v.clone() for k, v in self.static.items()}
            self._handed = {k: (weakref.ref(v), v._version,
                                self.static[k]._version)
                            for k, v in out.items()}
            return out
