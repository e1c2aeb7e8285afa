"""Wall-clock timer, API-compatible with the reference's `soil.timer`
(counterpart of `soillib_tpu/core/timer.py`):

    with soil.timer(soil.ms) as t:
        ...
    print(t.count)

Work on the card runs asynchronously, so a stopwatch around the host code
alone would time the launches. At the context exit the timer waits for the
card: it synchronises the devices of the tensors registered with
`t.wait(x)`, or the current CUDA device when none were registered, before
it reads the host clock. On the CPU there is nothing to wait for.
"""

from __future__ import annotations

import time

import torch

# Duration enumerators (the reference's soil.ns/us/ms/s).
ns = 0
us = 1
ms = 2
s = 3

_SCALE = {ns: 1e9, us: 1e6, ms: 1e3, s: 1.0}


def _synchronize(tensors):
    """Wait for every CUDA device the tensors live on; with no tensors,
    for the current CUDA device if there is one."""
    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    if not tensors and torch.cuda.is_available():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for d in devices:
        torch.cuda.synchronize(d)


class timer:
    def __init__(self, unit: int = ms):
        self._unit = unit
        self._start = None
        self._elapsed = 0.0
        self._pending = []

    def wait(self, *tensors):
        """Register tensors whose devices the exit waits for."""
        self._pending.extend(tensors)
        return tensors[0] if len(tensors) == 1 else tensors

    def __enter__(self):
        self._pending = []
        _synchronize(self._pending)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _synchronize(self._pending)
        self._elapsed = time.perf_counter() - self._start
        return False

    @property
    def count(self) -> int:
        """Elapsed time in the configured unit (integer, like the reference)."""
        return int(self._elapsed * _SCALE[self._unit])

    @property
    def elapsed(self) -> float:
        """Elapsed time in seconds (float)."""
        return self._elapsed


class profile:
    """`torch.profiler` trace of the block, written as a Chrome trace
    (viewable in Perfetto or chrome://tracing) into `logdir`; `path` is
    the file once the block has run:

        with soil.profile("trace_dir") as prof:
            state = soil.erode(state, scale, p)

    Records the CPU and, when a card is present, the CUDA activity; the
    exit synchronises the card so the trace holds the block's kernels."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = None
        self._prof = None

    def __enter__(self):
        import os

        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as _profile

        os.makedirs(self.logdir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = _profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import os

        _synchronize([])
        self._prof.__exit__(*exc)
        self.path = os.path.join(self.logdir, f"trace_{os.getpid()}.json")
        self._prof.export_chrome_trace(self.path)
        return False
