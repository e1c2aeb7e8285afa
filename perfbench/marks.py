"""The program's own records in a traced run: the phase marks captured into
its step's graph, read off the run's device operations, and its record of
graph set-up.

A captured erosion step holds five empty kernels, `soil_mark_<name>` for
the names of MARKS in that order (the program keeps the same tuple in
`soillib_tpu_torch/core/trace.py`). A complete group is a `step_begin`
followed by the other four in order before the next `step_begin`: one
replay. A group cut off at the window's edges or out of order is left out.
A phase lasts from its first mark's device start to its last mark's, so
the four phases of a group add up to its step span, `step_begin`'s start
to `step_end`'s. The idle share is read inside each group's
[`step_begin` start, `step_end` end]: between dependent nodes of the
graph, not between replays, which is the host's part. A program without
the marks (or a run without a replay) gives no group, and each reader
here then returns None.
"""

from __future__ import annotations

import re

from perfbench.trace import union_s

MARKS = ("step_begin", "fluvial_end", "debris_end", "update_end", "step_end")
# Phase i lies between MARKS[i] and MARKS[i + 1].
PHASES = ("fluvial_solve", "debris_solve", "update", "writeback")

_MARK = re.compile(r"soil_mark_([a-z_]+)")


def mark_name(op_name: str):
    """The mark an operation's name is (one of MARKS), or None."""
    m = _MARK.search(op_name)
    return m.group(1) if m and m.group(1) in MARKS else None


def groups(ops) -> list:
    """The complete mark groups among device operations (name, start,
    end, kind), in time order: each a list of the (start, end) of the
    five marks, in the order of MARKS."""
    seq = sorted((s, e, m) for name, s, e, _ in ops
                 if (m := mark_name(name)) is not None)
    out, cur = [], None
    for s, e, m in seq:
        if m == MARKS[0]:
            cur = [(s, e)]
        elif cur is not None and m == MARKS[len(cur)]:
            cur.append((s, e))
            if len(cur) == len(MARKS):
                out.append(cur)
                cur = None
        else:
            cur = None
    return out


def _phase_ms(gs, phase):
    i = PHASES.index(phase)
    return 1e3 * sum(g[i + 1][0] - g[i][0] for g in gs) / len(gs)


def _idle_pct(ops, gs):
    busy = span = 0.0
    for g in gs:
        t0, t1 = g[0][0], g[-1][1]
        busy += union_s([(max(s, t0), min(e, t1)) for _, s, e, _ in ops
                         if e > t0 and s < t1])
        span += t1 - t0
    return 100.0 * (1.0 - busy / span) if span > 0.0 else None


def phase_ms(rec, phase: str):
    """Device ms of `phase` (one of PHASES), mean over the complete
    groups of the record's device operations; None without a group."""
    gs = groups(rec["device_ops"])
    return _phase_ms(gs, phase) if gs else None


def step_idle_pct(rec):
    """100 * (1 - the union of the device operations inside each group's
    [step_begin start, step_end end] / that span), both summed over the
    groups; None without a group. Operations are clipped to the span, so
    the share lies in [0, 100]."""
    gs = groups(rec["device_ops"])
    return _idle_pct(rec["device_ops"], gs) if gs else None


def summary(rec):
    """Every reading of the marks in one dict: the groups read, the mean
    step span (ms, `step_begin` to `step_end` by their starts), each
    phase's ms and the idle share; None without a group."""
    gs = groups(rec["device_ops"])
    if not gs:
        return None
    out = {"groups": len(gs),
           "step_span_ms": 1e3 * sum(g[-1][0] - g[0][0] for g in gs)
           / len(gs)}
    out.update({f"{p}_ms": _phase_ms(gs, p) for p in PHASES})
    out["step_idle_pct"] = _idle_pct(rec["device_ops"], gs)
    return out


def fluvial_solve_ms_per_step(rec):
    return phase_ms(rec, "fluvial_solve")


def debris_solve_ms_per_step(rec):
    return phase_ms(rec, "debris_solve")


def update_ms_per_step(rec):
    return phase_ms(rec, "update")


def writeback_ms_per_step(rec):
    return phase_ms(rec, "writeback")


def graph_setup_s(rec):
    """Host seconds of the program's graph set-up in this process: warm-up
    step, capture and instantiation, summed over every step it captured
    (`soillib_tpu_torch.core.graphs.graph_setup`). None where the program
    keeps no such record or captured nothing. `rec` is not read: the
    record is the process's."""
    try:
        from soillib_tpu_torch.core.graphs import graph_setup
    except ImportError:
        return None
    r = graph_setup()
    if not r.get("steps"):
        return None
    return r["warmup_s"] + r["capture_s"] + r["instantiate_s"]
