"""The measured window.

Each step is one call of `step()`, the program's entry point, with a
CUDA event recorded after it; nothing synchronises per step. The host
keeps `runahead` steps queued ahead of the one it waits for (the run sets
that to some seconds of the cell's steps), so the card stays fed while
the host stands still, as a shared host now and then does for a tenth of
a second or more. When the window's seconds are up on the host's clock,
the host sends nothing more and waits for all it sent: every step sent
counts, and the window runs from an event recorded on the idle device
before the first call to the last step's event, so a stall that runs to
the end still counts as time. Steps that the check samples are sent
before the window may close.

`Keeper` copies the fields of the steps the check compares to host
memory on a side stream, into buffers made in set-up, so the window
neither waits for the copies nor holds extra states on the card.
"""

from __future__ import annotations

import time

import torch


class Clock:
    """Marks on the device's stream (CUDA events), or, on the CPU, where
    every step is synchronous, the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Keeper:
    """Host copies of named field dicts. `reserve(tag, like)` makes the
    buffers in set-up; `keep(tag, fields)` enqueues the copies after the
    work the current stream has queued; `get(tag)` waits for them."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.buf = {}
        self.done = {}

    def reserve(self, tag, like: dict):
        self.buf[tag] = {
            k: torch.empty(v.shape, dtype=v.dtype, pin_memory=self.cuda)
            for k, v in like.items()}

    def keep(self, tag, fields: dict):
        dst = self.buf[tag]
        if not self.cuda:
            for k, v in fields.items():
                dst[k].copy_(v)
            return
        ready = torch.cuda.Event()
        ready.record()
        self.side.wait_event(ready)
        with torch.cuda.stream(self.side):
            for k, v in fields.items():
                dst[k].copy_(v, non_blocking=True)
                v.record_stream(self.side)
            done = torch.cuda.Event()
            done.record()
        self.done[tag] = done

    def get(self, tag) -> dict:
        if tag in self.done:
            self.done.pop(tag).synchronize()
        return self.buf[tag]


def run(step, clock: Clock, seconds: float, runahead: int, *,
        before=None, after=None, until: int = 0) -> dict:
    """Calls `step()` until `seconds` have passed on the host's clock and
    `until` steps have been sent, waiting before each call on the event of
    the step `runahead` + 1 calls back; then waits for every step sent.
    `before(j)` and `after(j)` are called around step j (the check's
    copies). Returns the window's steps (`n`, all that were sent), its
    length (`window_s`: from the start event to the last step's event),
    every step interval in ms from the events (`intervals_ms`) and the host
    ms of each call (`host_ms`). The events time the device; a host that
    launches late leaves the device idle between them, which the window
    counts."""
    marks, host_ms = [], []
    waited = 0
    clock.sync()
    start = clock.mark()
    t0 = time.perf_counter()
    j = 0
    while j < max(until, 1) or time.perf_counter() - t0 < seconds:
        while waited < j - runahead:
            clock.wait(marks[waited])
            waited += 1
        if before is not None:
            before(j)
        th = time.perf_counter()
        step()
        host_ms.append((time.perf_counter() - th) * 1e3)
        marks.append(clock.mark())
        if after is not None:
            after(j)
        j += 1
    clock.sync()
    prev, intervals = start, []
    for m in marks:
        intervals.append(clock.ms(prev, m))
        prev = m
    return {"n": j, "window_s": clock.ms(start, marks[-1]) * 1e-3,
            "intervals_ms": intervals, "host_ms": host_ms}
