"""One run of one cell of the benchmark:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell's configuration names its pipeline
(`perfbench/pipelines/<name>.py`, "erosion" by default; see
`perfbench.spec`), which supplies what belongs to that kind of
configuration. In order: the cell's inputs from the seed, the program's
set-up and warm-up steps, the measured window of the program's `step()`
calls, with `--trace 1` a profiled window after it (the pipeline's
counters read around it), the pipeline's steps checked after the window,
then the check of the steps it sampled against the plain reference, and
one JSON line on stdout. It fails, and prints no result, without a CUDA
device (or with fewer than the cell asks for), or when the process has
loaded JAX or the JAX package. A run whose check finds a number over its
limit prints its line with `correct` false.

The last lines on stderr, and the result line's last key `checks`, give
each number compared beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import random
import statistics
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "soillib_tpu")
# Warm-up calls before the window (set-up): the first captures the step,
# the second settles the state's shapes (the erosion program broadcasts
# compact inputs in its first step).
WARMUP_STEPS = 3
# The window's steps queued ahead of the one the host waits for: AHEAD_S
# seconds of the cell's steps, timed in warm-up, and RUNAHEAD at least.
AHEAD_S = 5.0
RUNAHEAD = 2


def _process_start() -> float:
    """The process's start on the time.time() clock (Linux /proc), or
    now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def checked_steps(trf: dict, seed: int) -> tuple:
    """The steps the check compares: whether the first step (the first
    warm-up call, from the benchmark's own inputs) is one, and the window
    steps drawn from the seed (`window_samples` of the first `within`
    steps of the window, as indices into the window)."""
    chk = trf["check"]
    rng = random.Random(int(seed) * 7919 + 17)
    picks = sorted(rng.sample(range(int(chk["within"])),
                              int(chk["window_samples"])))
    return bool(chk["first_step"]), picks


def runahead(warm_s: list) -> int:
    """Steps to keep queued in the window: AHEAD_S seconds of steps at the
    median of the warm-up steps after the first (each timed on the host's
    clock to its synchronise), RUNAHEAD at least."""
    if not warm_s:
        return RUNAHEAD
    return max(RUNAHEAD, math.ceil(AHEAD_S / max(statistics.median(warm_s),
                                                 1e-6)))


def run_cell(cell: dict, bench: dict, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: float = None,
             here: str = None) -> dict:
    """Everything of a run but the look for a card and the printing:
    returns the result line as a dict, with `correct` and `checks`."""
    import torch

    from perfbench import check, spec, trace, window

    here = here or spec.HERE
    t_start = T_START if t_start is None else t_start
    cfg = spec.config(cell["config"], here)
    trf = spec.traffic(cell["traffic"], here)
    lim = spec.limits(cell["name"], here)["limits"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    pipe = spec.pipeline(spec.pipeline_name(cfg), here).Pipeline(
        cfg, trf, seed, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # Set-up: inputs, the program's set-up, warm-up.
    inputs = pipe.inputs()
    prog = pipe.setup(inputs)
    del inputs
    work = prog.work
    first, window_checks = checked_steps(trf, seed)
    keeper = window.Keeper(dev)
    clock = window.Clock(dev)

    # Warm-up: WARMUP_STEPS calls, then more for the mix's `warmup_s`
    # seconds, each synchronised; their times set the window's run-ahead.
    # For seconds to tens of seconds after the program's set-up the small
    # steps run slower (PERF.md); the 256^2 mixes step through that before
    # the window. Set-up that takes longer shows in setup_s one for one.
    warm, t_warm, warm_s, warm_host_ms = 0, None, [], []
    while warm < WARMUP_STEPS or time.time() - t_warm < trf["warmup_s"]:
        tw = time.perf_counter()
        prog.step()
        if warm >= WARMUP_STEPS - 1:
            warm_host_ms.append((time.perf_counter() - tw) * 1e3)
        if warm == 0 and first:
            clock.sync()
            keeper.reserve(("out", 0), prog.state())
            keeper.keep(("out", 0), prog.state())
        warm += 1
        clock.sync()
        if warm > 1:
            warm_s.append(time.perf_counter() - tw)
        if warm == WARMUP_STEPS:
            t_warm = time.time()
    ahead = runahead(warm_s)
    like = prog.state()
    for j in window_checks:
        keeper.reserve(("in", warm + j), like)
        keeper.reserve(("out", warm + j), like)
    del like
    gc.collect()
    steps_to_check = [0] * first + [warm + j for j in window_checks]

    def before(j):
        if j in window_checks:
            keeper.keep(("in", warm + j), prog.state())

    def after(j):
        if j in window_checks:
            keeper.keep(("out", warm + j), prog.state())

    setup_s = time.time() - t_start
    res = window.run(prog.step, clock, seconds, ahead,
                     before=before, after=after,
                     until=max(window_checks, default=-1) + 1)
    n = res["n"]
    ran = warm + n
    rec = None
    if traced:
        rec = trace.profiled_steps(prog.step, int(trf["profile_steps"]), dev,
                                   pipe.counters)
        # Each reading can only overstate the host's own cost of a call:
        # a window's call may wait for room in the launch queue, and a
        # warm-up call (on an idle device, after the captures) for the
        # device where the step reads it. The smaller is the reading.
        host_ms = statistics.fmean(res["host_ms"])
        if warm_host_ms:
            host_ms = min(host_ms, statistics.fmean(warm_host_ms))
        rec.update(host_ms_per_step=host_ms, **prog.record)
        ran += int(trf["profile_steps"])
    clock.sync()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    # The pipeline's steps checked after the window: one call each, from
    # the inputs it makes of the program's state (popped, so that the
    # program holds the only reference).
    extras = pipe.extra_inputs(prog.state())
    while extras:
        prog.load(extras.pop(0))
        for tag in ("in", "out"):
            keeper.reserve((tag, ran), prog.state())
        keeper.keep(("in", ran), prog.state())
        prog.step()
        keeper.keep(("out", ran), prog.state())
        steps_to_check.append(ran)
        ran += 1

    # The check, once the program's state is freed.
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings, gaps = [], []
    t_ref = time.time()
    for i in steps_to_check:
        if i == 0:
            inp = pipe.inputs()
            out = keeper.get(("out", 0))
        else:
            inp = {k: v.to(dev) for k, v in keeper.get(("in", i)).items()}
            out = keeper.get(("out", i))
        out = {k: v.to(dev) for k, v in out.items()}
        ref = pipe.reference(inp, i)
        gaps.append(pipe.gaps(inp, out, ref))
        readings.append(pipe.numbers(gaps[-1]))
        del inp, out, ref
    numbers = check.worst(readings)
    over = check.judge(numbers, lim)
    ref_s = time.time() - t_ref

    # The end-to-end metrics by base name (a `.part` twin reads as its
    # base): the rate is the pipeline's work a step over the window.
    measured = {"cell_steps_per_s": work * n / res["window_s"],
                "step_ms_p95": _p95(res["intervals_ms"]),
                "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], traced):
        if traced:
            v = spec.reader(m["name"], here)(rec)
        else:
            v = measured.get(m["name"].split(".", 1)[0])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": not over, "attempted": n, "failed": len(over),
           "metrics": metrics, "device": device_info}
    if traced:
        busy = trace.union_s([(s, e) for _, s, e, _ in rec["device_ops"]])
        device_info.update(busy_s=busy, window_s=rec["window_s"])
        out["breakdown"] = trace.breakdown(rec)
    out["info"] = {"seed": seed, "steps_checked": steps_to_check,
                   "steps_run": warm + n, "window_s": res["window_s"],
                   "setup_s": setup_s, "reference_s": ref_s,
                   "over_limit": over,
                   "step_ms": _step_summary(res["intervals_ms"]),
                   "field_gaps": check.worst(gaps)}
    if traced:
        out["info"]["traced"] = {"device_ops": len(rec["device_ops"]),
                                 "host_spans": len(rec["host_spans"]),
                                 "counters": rec["counters"],
                                 "profiled_window_s": rec["window_s"]}
    out["checks"] = {k: [_num(v), lim[k]] for k, v in numbers.items()}
    return out


def _step_summary(ms: list) -> dict:
    """The window's step intervals in short: all of them where there are
    few, else the first and last ten and the quartiles."""
    if len(ms) <= 40:
        return {"all": [round(v, 3) for v in ms]}
    q = statistics.quantiles(ms, n=4)
    return {"first": [round(v, 3) for v in ms[:10]],
            "last": [round(v, 3) for v in ms[-10:]],
            "quartiles": [round(v, 4) for v in q]}


def _num(v: float):
    """A number for JSON: non-finite ones as their names."""
    return v if math.isfinite(v) else repr(v)


def _p95(values) -> float:
    """The 95th percentile of `values` (statistics.quantiles, n=100,
    the 'exclusive' method)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=100)[94]


def _card_line() -> str:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {cell['name']} needs {cell['chips']} CUDA "
              f"devices, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, bench, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process has loaded {bad}", file=sys.stderr)
        return 3
    out["info"]["card"] = _card_line()
    checks = out.pop("checks")
    out["checks"] = checks
    print("perfbench: " + json.dumps(out["info"]), file=sys.stderr)
    for k, (v, lim) in checks.items():
        flag = "OVER" if k in out["info"]["over_limit"] else "ok"
        print(f"check {k} {v!r} limit {lim!r} {flag}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
