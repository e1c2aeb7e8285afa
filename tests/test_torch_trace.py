"""The port's tracing (`soillib_tpu_torch/core/trace.py`): the phase marks
captured into the step's graph, the driver's host spans and the graph's
set-up record, and the benchmark's reductions of them
(`perfbench/marks.py`) on synthetic traces.

On the CPU: the reductions, the spans under a CPU profiler run of
`ErosionSim.step()`, that no span is entered and no mark launched without
a profiler or a capture, and that the names agree. On the card (`cuda`
marker; `python -m pytest tests/test_torch_trace.py -q --noconftest`):
one captured step holds the five marks in order, and the marks leave the
step bitwise as it is without them. This file imports no JAX.
"""

import os
import random
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import soillib_tpu_torch as soil
from perfbench import marks, spec
from perfbench import trace as pbtrace
from soillib_tpu_torch.core import graphs, trace
from soillib_tpu_torch.models import simulation

SCALE = (0.1, 0.1, 4.0)
N = 16
MS = 1e-3
SPANS = ("soil.step", "soil.step.copy_in", "soil.step.replay",
         "soil.step.clone_out")
METRICS = ("fluvial_solve_ms_per_step", "debris_solve_ms_per_step",
           "update_ms_per_step", "writeback_ms_per_step", "step_idle_pct")


def _mark(name, t):
    return (f"soil_mark_{name}", t, t + 1e-6, "kernel")


def _group(t0, phases_ms=(3.0, 2.0, 1.0, 0.5)):
    """One replay's marks from t0 (s), the phases lasting `phases_ms`, and
    a kernel that fills each phase but its last 0.1 ms."""
    ops, t = [_mark("step_begin", t0)], t0
    for name, ms in zip(marks.MARKS[1:], phases_ms):
        ops.append(("void work_kernel()", t + 2e-6, t + (ms - 0.1) * MS,
                    "kernel"))
        t += ms * MS
        ops.append(_mark(name, t))
    return ops


def _rec(ops):
    return {"device_ops": ops, "host_spans": [], "steps": 2, "t0": 0.0,
            "t1": 1.0, "counters": {}}


# ---------------------------------------------------------------------------
# perfbench/marks.py on synthetic traces
# ---------------------------------------------------------------------------


def test_phase_ms_are_means_over_groups_and_sum_to_the_step_span():
    rec = _rec(_group(0.0) + _group(0.01, (5.0, 2.0, 1.0, 0.5)))
    assert len(marks.groups(rec["device_ops"])) == 2
    want = {"fluvial_solve_ms_per_step": 4.0, "debris_solve_ms_per_step": 2.0,
            "update_ms_per_step": 1.0, "writeback_ms_per_step": 0.5}
    for name, ms in want.items():
        assert spec.reader(name)(rec) == pytest.approx(ms)
        # The 256^2 twin reads with its base's reader.
        assert spec.reader(name + ".small")(rec) == pytest.approx(ms)
    s = marks.summary(rec)
    assert s["groups"] == 2 and s["step_span_ms"] == pytest.approx(7.5)
    assert sum(s[f"{p}_ms"] for p in marks.PHASES) == pytest.approx(
        s["step_span_ms"])


def test_groups_cut_at_the_window_edges_or_out_of_order_are_left_out():
    whole = _group(0.01)
    head = [op for op in _group(0.0) if op[1] > 0.004]   # begins mid-step
    tail = _group(0.02)[:3]                               # ends mid-step
    wrong = [_mark(m, 0.03 + i * MS) for i, m in enumerate(
        ("step_begin", "debris_end", "fluvial_end", "update_end",
         "step_end"))]
    ops = head + whole + tail + wrong
    random.Random(3).shuffle(ops)
    gs = marks.groups(ops)
    assert len(gs) == 1 and gs[0][0][0] == pytest.approx(0.01)
    assert marks.phase_ms(_rec(ops), "fluvial_solve") == pytest.approx(3.0)


def test_idle_share_counts_overlap_once_and_stays_within_0_and_100():
    begin, end = _mark("step_begin", 0.0), _mark("step_end", 10 * MS)
    mid = [_mark(m, t * MS) for m, t in (("fluvial_end", 4.0),
                                         ("debris_end", 6.0),
                                         ("update_end", 9.0))]
    work = [("a", 0.0, 4 * MS, "kernel"), ("b", 2 * MS, 6 * MS, "kernel"),
            ("Memcpy DtoD", 8 * MS, 10 * MS + 1e-6, "memcpy")]
    rec = _rec([begin, *mid, end, *work])
    # Busy [0, 6] (and debris_end's 1 us past it) and [8, 10]: 2 ms less
    # 1 us of the 10 ms and 1 us idle.
    assert spec.reader("step_idle_pct")(rec) == pytest.approx(
        100 * (2 * MS - 1e-6) / (10 * MS + 1e-6))
    # Operations reaching past the span are clipped to it: never below 0.
    wide = _rec([begin, *mid, end, ("x", -1.0, 1.0, "kernel")])
    assert spec.reader("step_idle_pct.small")(wide) == 0.0
    # Only the marks: nearly all idle, never above 100.
    bare = spec.reader("step_idle_pct")(_rec([begin, *mid, end]))
    assert 99.0 < bare <= 100.0
    rng = random.Random(7)
    for _ in range(50):
        ops = [begin, *mid, end]
        for _ in range(rng.randrange(20)):
            s = rng.uniform(-2 * MS, 12 * MS)
            ops.append(("k", s, s + rng.uniform(0.0, 4 * MS), "kernel"))
        assert 0.0 <= marks.step_idle_pct(_rec(ops)) <= 100.0


def test_no_complete_group_reads_none():
    ops = [("void work_kernel()", 0.0, 1.0, "kernel")]
    for rec in (_rec(ops), _rec(ops + _group(2.0)[:4]), _rec([])):
        assert marks.summary(rec) is None
        for name in METRICS:
            assert spec.reader(name)(rec) is None


def test_mark_names_match_the_program_and_the_kernel_source():
    assert marks.MARKS == trace.MARKS
    assert all(marks.mark_name(f"soil_mark_{m}") == m for m in trace.MARKS)
    assert marks.mark_name("void soil_mark_step_end()") == "step_end"
    assert marks.mark_name("soil_mark_other") is None
    path = os.path.join(os.path.dirname(soil.__file__), "csrc",
                        "trace_mark.cu")
    with open(path) as f:
        src = f.read()
    assert tuple(re.findall(r"^SOIL_MARK\((\w+)\)", src, re.M)) == \
        trace.MARKS
    assert tuple(re.findall(r"case \d: soil_mark_(\w+)<<<", src)) == \
        trace.MARKS


def test_new_metrics_are_declared_for_every_cell_of_their_rate():
    b = spec.benchmark()
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for name in METRICS:
        assert per_layer[name]["moves"] == "cell_steps_per_s"
        assert per_layer[name + ".small"]["moves"] == "cell_steps_per_s.small"
        assert "workloads" not in per_layer[name]
    assert per_layer["graph_setup_s"]["moves"] == "setup_s"
    for cell in b["workloads"]:
        names = {m["name"] for m in spec.metrics_of(b, cell["name"], True)}
        assert "graph_setup_s" in names
        assert len(names & {n for m in METRICS for n in (m, m + ".small")}) \
            == len(METRICS)


def test_graph_setup_reads_the_process_record(monkeypatch):
    monkeypatch.setattr(graphs, "_setup", {"steps": 0, "warmup_s": 0.0,
                                           "capture_s": 0.0,
                                           "instantiate_s": 0.0})
    assert spec.reader("graph_setup_s")(_rec([])) is None
    # The CPU runs the step eagerly: nothing is captured or recorded.
    _cpu_sim().step()
    assert graphs.graph_setup()["steps"] == 0
    graphs._setup.update(steps=2, warmup_s=1.0, capture_s=0.5,
                         instantiate_s=0.25)
    assert spec.reader("graph_setup_s")(_rec([])) == pytest.approx(1.75)
    got = graphs.graph_setup()
    got["steps"] = 9  # a copy
    assert graphs.graph_setup()["steps"] == 2


# ---------------------------------------------------------------------------
# The driver's spans and marks on the CPU
# ---------------------------------------------------------------------------


def _cpu_sim():
    simulation._compiled.clear()
    p = soil.ErosionParams()
    p.transportIterations = 4
    h = torch.linspace(0.0, 1.0, N * N).reshape(N, N)
    return soil.ErosionSim((N, N), SCALE, p, state=soil.ErosionState.zeros(
        (N, N), height=h, device="cpu"), device="cpu")


def test_driver_spans_nest_in_the_callers_span_on_one_clock():
    sim = _cpu_sim()
    sim.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            sim.step()
    # The benchmark's own reading of a trace's host spans.
    _, host = pbtrace._events(prof)
    got = {n: (s, e) for n, s, e in host if n == "caller" or
           n.startswith("soil.")}
    assert set(got) == {"caller", *SPANS}
    c0, c1 = got["caller"]
    s0, s1 = got["soil.step"]
    assert c0 <= s0 < s1 <= c1
    inner = [got[n] for n in SPANS[1:]]
    assert all(s0 <= a < b <= s1 for a, b in inner)
    assert all(x[1] <= y[0] for x, y in zip(inner, inner[1:]))  # in order
    # The breakdown names a time inside the replay by its span.
    mid = 0.5 * sum(got["soil.step.replay"])
    assert pbtrace.host_doing(mid, [(n, s, e) for n, s, e in host
                                    if n in got]) == "host: soil.step.replay"


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    sim = _cpu_sim()
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    sim.step(2)
    assert entered == []
    # The same calls with the profiler's flag up enter every span once.
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    sim.step(2)
    assert entered == list(SPANS)


def test_mark_launches_nothing_outside_a_capture(monkeypatch):
    def no_library():
        raise AssertionError("a mark was launched outside a capture")

    monkeypatch.setattr(trace, "_mark_lib", no_library)
    for name in trace.MARKS:
        trace.mark(name)
    sim = _cpu_sim()
    sim.step()   # CapturedStep on the CPU: buffers around an eager step
    simulation.erode_step(sim.state, SCALE, sim.param)   # the eager step


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mark kernels have no CPU mode")


def _card_config(n=128):
    simulation._compiled.clear()
    p = soil.ErosionParams()
    p.transportIterations = 8
    p.trackAlbedo = True
    x = torch.linspace(0, 6, n, device="cuda")[:, None]
    y = torch.linspace(0, 5, n, device="cuda")[None, :]
    h = 2.0 + 0.3 * torch.sin(x) * torch.cos(y)
    return p, soil.ErosionState.zeros((n, n), height=h)


def _mark_names(rec):
    ops = sorted(rec["device_ops"], key=lambda op: op[1])
    return [m for name, *_ in ops if (m := marks.mark_name(name))]


@pytest.mark.cuda
def test_captured_step_holds_five_marks_in_order_on_card():
    _needs_card()
    p, state = _card_config()
    before = graphs.graph_setup()
    fn = soil.make_erode_fn(p, SCALE, 1)
    out = fn(state)   # captures
    after = graphs.graph_setup()
    assert after["steps"] == before["steps"] + 1
    assert all(after[k] > before[k] for k in ("warmup_s", "capture_s",
                                              "instantiate_s"))
    dev = torch.device("cuda", torch.cuda.current_device())
    rec = pbtrace.profiled_steps(lambda: fn(out), 3, dev, dict)
    # A fresh profiler session may miss the first kernel of the first
    # replay it traces; every replay after it shows its five marks in
    # order and no other.
    full = list(trace.MARKS) * 3
    assert _mark_names(rec) in (full, full[1:])
    s = marks.summary(rec)
    assert s["groups"] >= 2 and 0.0 <= s["step_idle_pct"] <= 100.0
    assert sum(s[f"{ph}_ms"] for ph in marks.PHASES) == pytest.approx(
        s["step_span_ms"])
    assert all(s[f"{ph}_ms"] > 0.0 for ph in marks.PHASES)
    # The eager step on the card launches no mark.
    eager = pbtrace.profiled_steps(
        lambda: simulation.erode_step(out, SCALE, p), 1, dev, dict)
    assert _mark_names(eager) == []
    simulation._compiled.clear()


@pytest.mark.cuda
def test_marks_leave_the_step_bitwise_on_card(monkeypatch):
    _needs_card()
    p, state = _card_config()
    marked = soil.make_erode_fn(p, SCALE, 2)(state)
    simulation._compiled.clear()
    monkeypatch.setattr(simulation, "mark", lambda name: None)
    monkeypatch.setattr(graphs, "mark", lambda name: None)
    plain = soil.make_erode_fn(p, SCALE, 2)(state)
    simulation._compiled.clear()
    for f in simulation.FIELDS:
        a, b = getattr(marked, f), getattr(plain, f)
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32)), f
