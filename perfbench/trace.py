"""The traced run's record and its reductions.

`profiled_steps` runs steps under torch.profiler (CPU and CUDA activity)
and returns what the metric readers read: the device operations (kernels,
copies, fills) as (name, start s, end s, kind) and the host spans of the
main thread, on one clock. The reductions here (the union of intervals,
the idle gaps and what the host did in them, the top operations) are
plain arithmetic on such lists, tested on synthetic traces.
"""

from __future__ import annotations

import time


def is_cohort(name: str) -> bool:
    """A cohort round kernel of csrc/cohort_round.cu."""
    return "cohort_round" in name


def is_particle(name: str) -> bool:
    """A trajectory kernel of csrc/particle_rounds.cu (either estimator)."""
    return "particle_rounds_kernel" in name


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and argument list."""
    s = name.strip()
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            s = s[:i]
            break
    if is_cohort(s):
        s = "cohort round kernel: " + s
    return s[:limit]


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, t0: float, t1: float) -> list:
    """The (start, end) stretches of [t0, t1] that no interval covers."""
    out, cursor = [], t0
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, t1)))
        cursor = max(cursor, e)
        if cursor >= t1:
            break
    if cursor < t1:
        out.append((cursor, t1))
    return [(s, e) for s, e in out if e > s]


def host_doing(t: float, host_spans) -> str:
    """The innermost host span (name, start, end) that holds time t."""
    best = None
    for name, s, e in host_spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return "host: " + (best[0][:80] if best else "nothing traced")


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations with the most time (seconds over the
    profiled steps, by short name) and the longest idle gaps, each named
    by what the host was doing at its middle."""
    by_name = {}
    for name, s, e, _ in rec["device_ops"]:
        k = short_name(name)
        by_name[k] = by_name.get(k, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = idle_gaps([(s, e) for _, s, e, _ in rec["device_ops"]],
                     rec["t0"], rec["t1"])
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[host_doing(0.5 * (s + e), rec["host_spans"]),
                           e - s] for s, e in gaps]}


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _events(prof):
    """(device ops, host spans of the main thread) from a finished
    profiler, in seconds on the trace's clock. Device events that are
    user annotations (the spans' images on the device's timeline) are
    not operations."""
    from torch.autograd import DeviceType

    dev, host, threads = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = ev.end_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                dev.append((ev.name(), s, e, _device_kind(ev.name())))
        elif (ev.device_type() == DeviceType.CPU
              and not ev.name().startswith("Activity Buffer")):
            tid = ev.start_thread_id()
            threads[tid] = threads.get(tid, 0) + 1
            host.append((tid, ev.name(), s, e))
    # The main thread is the one with the most host events.
    tid = max(threads, key=threads.get) if threads else None
    return dev, [(n, s, e) for t, n, s, e in host if t == tid]


def profiled_steps(step, steps: int, device, counters) -> dict:
    """`steps` calls of `step()` under torch.profiler, each in a
    `perfbench.step` span, then a synchronise. On a CPU device (the
    harness's tests) the profiler traces the host alone and there is no
    device operation. Returns the record's trace
    part: device_ops, host_spans, t0 and t1 (the traced window on the
    trace's clock), window_s (its length on the host clock), steps, and
    the change of `counters()` (a dict of dicts of counts) over the
    steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    c0 = counters()
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with profile(activities=activities) as prof:
        with record_function("perfbench.window"):
            t0 = time.perf_counter()
            for _ in range(int(steps)):
                with record_function("perfbench.step"):
                    step()
            sync()
            window_s = time.perf_counter() - t0
    c1 = counters()
    dev, host = _events(prof)
    win = [(s, e) for n, s, e in host if n == "perfbench.window"]
    t0s, t1s = (win[0] if win else
                (min(s for _, s, _, _ in dev), max(e for _, _, e, _ in dev)))
    delta = {k: {n: v - c0[k].get(n, 0) for n, v in c1[k].items()
                 if v != c0[k].get(n, 0)} for k in c1}
    return {"device_ops": dev, "host_spans": host, "t0": t0s, "t1": t1s,
            "window_s": window_s, "steps": int(steps), "counters": delta}
