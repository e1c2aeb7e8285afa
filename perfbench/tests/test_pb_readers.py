"""The per-layer readers' arithmetic and the window's statistics on
synthetic traces."""

import math

import pytest

from perfbench import run, spec, trace, yardstick


def _rec(ops, steps=2, **kw):
    rec = {"device_ops": ops, "host_spans": [], "steps": steps, "t0": 0.0,
           "t1": 1.0, "counters": {}, "cells": 100,
           "albedo": True, "host_ms_per_step": 0.25}
    rec.update(kw)
    return rec


def test_union_counts_overlap_once():
    assert trace.union_s([(0.0, 1.0), (0.5, 1.5), (2.0, 3.0)]) == 2.5
    assert trace.union_s([(0.0, 4.0), (1.0, 2.0)]) == 4.0
    assert trace.union_s([]) == 0.0


def test_idle_gaps_and_breakdown():
    ops = [("a", 0.1, 0.2, "kernel"), ("b", 0.15, 0.3, "kernel"),
           ("void cohort_rounds_kernel(CohortParams, int)", 0.6, 0.9,
            "kernel")]
    assert trace.idle_gaps([(s, e) for _, s, e, _ in ops], 0.0, 1.0) == [
        (0.0, 0.1), (0.3, 0.6), (0.9, 1.0)]
    rec = _rec(ops, host_spans=[("perfbench.step", 0.0, 1.0),
                                ("cudaGraphLaunch", 0.35, 0.5)])
    bd = trace.breakdown(rec)
    assert bd["device_ops"][0][0].startswith("cohort round kernel")
    assert bd["device_ops"][0][1] == pytest.approx(0.3)
    assert bd["idle_gaps"][0] == ["host: cudaGraphLaunch",
                                  pytest.approx(0.3)]
    assert len(bd["idle_gaps"]) == 3


def test_kernels_glue_particles():
    ops = [("void cohort_rounds_kernel(x)", 0.0, 0.1, "kernel"),
           ("elementwise", 0.1, 0.15, "kernel"),
           ("Memcpy DtoD", 0.15, 0.17, "memcpy"),
           ("void (anonymous namespace)::particle_rounds_kernel<0>(x)", 0.2,
            0.21, "kernel")]
    rounds = {"particle_rounds": {"fluvial": 1000}}
    rec = _rec(ops, counters=rounds)
    assert spec.reader("kernels_per_step")(rec) == 1.5
    assert spec.reader("glue_ms_per_step")(rec) == pytest.approx(40.0)
    assert spec.reader("particle_roofline_pct")(rec) == pytest.approx(
        100 * 1000 * 48 / 3.35e12 / 0.01)
    assert spec.reader("particle_roofline_pct")(_rec(ops[:2],
                                                     counters=rounds)) is None
    assert spec.reader("host_ms_per_step")(rec) == 0.25
    # A twin without a file of its own reads with its base's reader.
    assert spec.reader("kernels_per_step.small")(rec) == 1.5


def test_roofline_takes_rounds_from_the_counter():
    cells = 4096 * 4096
    per_round = {k: yardstick.round_bound_s(k, True, cells)
                 for k in ("fluvial", "debris")}
    # The PR 13 kernel table's bounds by operations at 4096^2.
    assert per_round["fluvial"] == pytest.approx(0.815e-3, rel=2e-3)
    assert per_round["debris"] == pytest.approx(0.904e-3, rel=2e-3)
    t = 0.1
    ops = [("void cohort_rounds_kernel(x)", 0.0, t, "kernel")]
    rec = _rec(ops, cells=cells,
               counters={"cohort_rounds": {"fluvial": 64, "debris": 12}})
    want = 100 * (64 * per_round["fluvial"] + 12 * per_round["debris"]) / t
    assert spec.reader("cohort_roofline_pct")(rec) == pytest.approx(want)
    # No rounds counted, or no cohort kernel: nothing to read.
    assert spec.reader("cohort_roofline_pct")(_rec(ops)) is None
    assert spec.reader("cohort_roofline_pct")(
        _rec([("x", 0.0, 1.0, "kernel")], counters={
            "cohort_rounds": {"fluvial": 1}})) is None


def test_p95_over_every_step():
    values = [1.0] * 95 + [10.0] * 5
    assert 1.0 < run._p95(values) <= 10.0
    assert run._p95(list(range(1, 201))) == pytest.approx(190.95)
    assert run._p95([3.0]) == 3.0
    assert math.isclose(run._p95([2.0, 2.0]), 2.0)
