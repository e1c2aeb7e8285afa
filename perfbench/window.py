"""The measured window.

Each step is one call of `step()`, the program's entry point, with a
CUDA event recorded after it; nothing synchronises per step. Before each
call the host waits on the event of the step `runahead` + 1 calls back,
so a device-bound cell queues no work past its window and a host stall
still shows as a gap. The window closes at the first step whose event
falls past `seconds` after the window's start; it holds that step and
those before it. Steps that the check samples and the window did not
reach run after it, outside the window.

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
    """Calls `step()` until the window closes, then until `until` steps
    have run. `before(j)` and `after(j)` are called around step j (the
    check's copies). Returns the window's steps (`n`), its length
    (`window_s`: from the start event, recorded on the idle device before
    the first call, to the closing step's event), every step interval in
    ms from the events (`intervals_ms`), the host ms of each call
    (`host_ms`) and the steps run in all (`ran`). The events time the
    device; a host that launches late leaves the device idle between
    them, which the window counts."""
    marks, host_ms = [], []
    checked, close = 0, None
    clock.sync()
    start = clock.mark()
    j = 0
    while True:
        # Bound the run-ahead, and close the window at the first completed
        # step past `seconds`.
        while close is None and checked < j - runahead:
            clock.wait(marks[checked])
            if clock.ms(start, marks[checked]) > seconds * 1e3:
                close = checked
            checked += 1
        if close is not None and j >= until:
            break
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
    for m in marks[:close + 1]:
        intervals.append(clock.ms(prev, m))
        prev = m
    return {"n": close + 1,
            "window_s": clock.ms(start, marks[close]) * 1e-3,
            "intervals_ms": intervals, "host_ms": host_ms[:close + 1],
            "ran": len(marks)}
