"""What the port's step tells a trace about itself: phase marks captured
into the step's CUDA graph, and host spans in the driver.

Marks. `mark(name)` launches csrc/trace_mark.cu's empty kernel
`soil_mark_<name>` (one block, one thread, no work) on the current stream,
but only while that stream is being captured into a CUDA graph: the mark
is then a node of the graph and runs on every replay, in stream order, so
its device start time is the boundary between what the step captured
before it and what it captured after. Outside a capture (eager steps on
the card, the CPU) it launches nothing. A captured erosion step holds the
five of `MARKS`, in that order; between them lie its four phases: the
fluvial solve, the debris solve, the update (blend,
transfer, creep, albedo) and the write-back (the graph's copies into its
buffers).

Spans. `span(name)` is `torch.profiler.record_function(name)` while a
torch profiler runs, and a context that does nothing otherwise: the cost
with no profiler is one flag read. The spans are the profiler's own
events, so they share the device trace's clock, and `soil.profile`'s
Chrome traces show them. The driver's spans (`core/graphs.py`
`CapturedStep.__call__`, `models/simulation.py` `ErosionSim.step`):

    soil.step                the call
    soil.step.copy_in        the caller's fields into the graph's buffers
    soil.step.replay         the replays (the eager steps on the CPU)
    soil.step.read_counts    the one read of the device's counts a call
    soil.step.clone_out      the returned copies of the buffers

The launch counters stay in `core/graphs.py`.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
from torch.autograd import profiler as _autograd_profiler

MARKS = ("step_begin", "fluvial_end", "debris_end", "update_end", "step_end")

_NO_SPAN = contextlib.nullcontext()
_lib = None


def span(name: str):
    """A `record_function(name)` span while a torch profiler runs; a
    context that does nothing otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _mark_lib():
    global _lib
    if _lib is None:
        from soillib_tpu_torch import _native

        lib = _native.load("trace_mark")
        lib.soil_mark_prepare.argtypes = []
        lib.soil_mark_prepare.restype = ctypes.c_int
        lib.soil_mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.soil_mark_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def prepare_marks(device) -> None:
    """Builds or loads the mark kernels and loads them into `device`'s
    context, so that a capture that follows loads no module. Call it
    before the capture begins."""
    with torch.cuda.device(device):
        err = _mark_lib().soil_mark_prepare()
    if err != 0:
        raise RuntimeError(f"mark kernels not loaded: CUDA error {err}")


def mark(name: str) -> None:
    """Captures the mark `name` (one of MARKS) into the graph that the
    current stream is capturing; launches nothing outside a capture."""
    if not (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        return
    which = MARKS.index(name)
    stream = torch.cuda.current_stream().cuda_stream
    err = _mark_lib().soil_mark_launch(which, stream)
    if err != 0:
        raise RuntimeError(f"mark {name} not captured: CUDA error {err}")
