"""The window on the CPU clock: every step sent counts, the window closes on
the host's clock once the steps to check were sent, and the run-ahead is
some seconds of the warm-up's steps."""

import time

from perfbench import run, window


def _steps(pause_s=0.0):
    calls = []

    def step():
        time.sleep(pause_s)
        calls.append(1)

    return step, calls


def test_every_step_sent_counts():
    step, calls = _steps(0.002)
    res = window.run(step, window.Clock("cpu"), 0.05, 3)
    assert res["n"] == len(calls) == len(res["intervals_ms"])
    assert len(res["host_ms"]) == res["n"]
    assert res["window_s"] >= 0.05
    assert abs(sum(res["intervals_ms"]) * 1e-3 - res["window_s"]) < 1e-9


def test_window_waits_for_the_steps_to_check():
    step, calls = _steps()
    seen = []
    res = window.run(step, window.Clock("cpu"), 0.0, 3, until=40,
                     before=lambda j: seen.append(("in", j)),
                     after=lambda j: seen.append(("out", j)))
    assert res["n"] == len(calls) == 40
    assert seen[:2] == [("in", 0), ("out", 0)] and seen[-1] == ("out", 39)


def test_runahead_is_seconds_of_warmup_steps():
    assert run.runahead([]) == run.RUNAHEAD
    assert run.runahead([0.002, 0.0016, 0.0017]) == 2942  # 5 s / 1.7 ms
    assert run.runahead([0.18, 0.17]) == 29
    assert run.runahead([2.4, 2.3]) == 3
    assert run.runahead([9.0]) == run.RUNAHEAD
