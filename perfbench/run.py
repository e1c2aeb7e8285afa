"""One run of one cell of the benchmark:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. In order: the cell's inputs from the seed
(the terrain, the state, the particle seed), the program's set-up
(`soillib_tpu_torch.ErosionSim`: its kernels built or loaded from
`soillib_tpu_torch/_build/`, its step captured as a CUDA graph) and warm-up
steps, the measured window of `ErosionSim.step()` calls, with `--trace 1`
a profiled window after it, the albedo step (one more call from the
program's state with its albedos drawn from the seed), then the check of
the steps it sampled and of the albedo step against the plain reference,
and one JSON line on stdout. It fails, and
prints no result, without a CUDA device (or with fewer than the cell
asks for), or when the process has loaded JAX or the JAX package. A run
whose check finds a number over its limit prints its line with `correct`
false.

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
# the second settles the state's shapes (compact albedo fields broadcast).
WARMUP_STEPS = 3
# Calls in flight before the host waits: it waits on the event of the
# step RUNAHEAD + 1 calls back.
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


def make_fields(cfg: dict, trf: dict, seed: int, device) -> dict:
    """The cell's initial state, as a dict of the program's ErosionState
    fields, made by the benchmark on `device` from the seed."""
    import torch

    from perfbench import terrain

    W, H = cfg["grid"]
    h = terrain.height(cfg["terrain"], trf["terrain"], (W, H), seed, device)
    st = cfg["state"]

    def f(*c):
        return torch.zeros((*c, W, H), dtype=torch.float32, device=device)

    def scalar_field(v, default):
        if v is None:
            return torch.full((W, H), float(default), dtype=torch.float32,
                              device=device)
        return torch.full((1, 1), float(v), dtype=torch.float32,
                          device=device)

    def color(v):
        if v is None:
            return torch.ones((3, W, H), dtype=torch.float32, device=device)
        return torch.tensor(v, dtype=torch.float32,
                            device=device).reshape(3, 1, 1)

    surface = color(st["albedo_surface"])
    return {
        "layers": torch.stack([h, f()], dim=0),
        "rainfall": scalar_field(st["rainfall"], 1.0),
        "uplift": scalar_field(st["uplift"], 0.0),
        "discharge": f(), "mass": f(), "momentum": f(2), "debris": f(),
        "debris_momentum": f(2),
        "albedo_bedrock": color(st["albedo_bedrock"]),
        "albedo_surface": surface, "albedo_fluvial": surface,
        "albedo_debris": surface,
    }


def checked_steps(trf: dict, seed: int) -> tuple:
    """The steps the check compares: whether the first step (the first
    warm-up call, from the benchmark's own state) is one, and the window
    steps drawn from the seed (`window_samples` of the first `within`
    steps of the window, as indices into the window)."""
    chk = trf["check"]
    rng = random.Random(int(seed) * 7919 + 17)
    picks = sorted(rng.sample(range(int(chk["within"])),
                              int(chk["window_samples"])))
    return bool(chk["first_step"]), picks


def with_drawn_albedos(fields: dict, seed: int) -> dict:
    """`fields` with each albedo field replaced by one of the same shape
    drawn from the seed on its device, uniform in [0.2, 1) in every entry:
    the input of the albedo step that the check compares."""
    import torch

    out = dict(fields)
    ref = fields["albedo_surface"]
    g = torch.Generator(device=ref.device).manual_seed(
        (int(seed) * 0x9E3779B97F4A7C15 + 5) % (1 << 63))
    for f in ("albedo_bedrock", "albedo_surface", "albedo_fluvial",
              "albedo_debris"):
        a = fields[f]
        out[f] = 0.2 + 0.8 * torch.rand(a.shape, generator=g,
                                        dtype=a.dtype, device=a.device)
    return out


def program_params(soil, p: dict):
    param = soil.ErosionParams()
    for k, v in p.items():
        setattr(param, k, v)
    return param


def run_cell(cell: dict, bench: dict, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: float = None,
             here: str = None) -> dict:
    """Everything of a run but the look for a card and the printing:
    returns the result line as a dict, with `correct` and `checks`."""
    import torch

    import soillib_tpu_torch as soil
    from perfbench import check, spec, terrain, trace, window
    from perfbench.reference import rng, step as reference

    here = here or spec.HERE
    t_start = T_START if t_start is None else t_start
    cfg = spec.config(cell["config"], here)
    trf = spec.traffic(cell["traffic"], here)
    lim = spec.limits(cell["name"], here)["limits"]
    p = spec.params(cfg, trf)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    W, H = cfg["grid"]
    scale = tuple(float(s) for s in cfg["scale"])
    particles = p["transportMethod"] == "particles"
    sim_seed = terrain.sim_seed(seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # Set-up: inputs, the program's simulation, warm-up.
    fields0 = make_fields(cfg, trf, seed, dev)
    sim = soil.ErosionSim((W, H), scale, program_params(soil, p),
                          state=soil.ErosionState(**fields0), seed=sim_seed,
                          device=dev)
    del fields0
    first, window_checks = checked_steps(trf, seed)
    keeper = window.Keeper(dev)
    clock = window.Clock(dev)

    def state_dict():
        return {f: getattr(sim.state, f) for f in reference.FIELDS}

    # Warm-up: WARMUP_STEPS calls, then more for the mix's `warmup_s`
    # seconds. After the program's set-up every small kernel of the
    # process runs ~15% slower for seconds to tens of seconds (PERF.md);
    # the 256^2 mixes step through that before the window. Set-up that
    # takes longer shows in setup_s one for one.
    warm, t_warm = 0, None
    while warm < WARMUP_STEPS or time.time() - t_warm < trf["warmup_s"]:
        sim.step()
        if warm == 0 and first:
            clock.sync()
            keeper.reserve(("out", 0), state_dict())
            keeper.keep(("out", 0), state_dict())
        warm += 1
        clock.sync()
        if warm == WARMUP_STEPS:
            t_warm = time.time()
    like = state_dict()
    for j in window_checks:
        keeper.reserve(("in", warm + j), like)
        keeper.reserve(("out", warm + j), like)
    del like
    gc.collect()
    steps_to_check = [0] * first + [warm + j for j in window_checks]

    def before(j):
        if j in window_checks:
            keeper.keep(("in", warm + j), state_dict())

    def after(j):
        if j in window_checks:
            keeper.keep(("out", warm + j), state_dict())

    setup_s = time.time() - t_start
    res = window.run(sim.step, clock, seconds, RUNAHEAD,
                     before=before, after=after,
                     until=max(window_checks, default=-1) + 1)
    n = res["n"]
    rec = None
    if traced:
        from soillib_tpu_torch.ops import cohort

        rec = trace.profiled_steps(
            sim.step, int(trf["profile_steps"]), dev,
            lambda: {"cohort_rounds": dict(cohort.cohort_rounds)})
        rec.update(host_ms_per_step=statistics.fmean(res["host_ms"]),
                   cells=W * H, albedo=bool(p["trackAlbedo"]))
    clock.sync()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    if p["trackAlbedo"]:
        # The albedo step: one more call, outside the window, from the
        # program's state with its albedos drawn from the seed. The
        # configurations' albedos are uniform, which leaves the albedo
        # arithmetic unseen by the steps above.
        i = warm + res["ran"] + (int(trf["profile_steps"]) if traced else 0)
        sim.state = soil.ErosionState(**with_drawn_albedos(state_dict(),
                                                           seed))
        for tag in ("in", "out"):
            keeper.reserve((tag, i), state_dict())
        keeper.keep(("in", i), state_dict())
        sim.step()
        keeper.keep(("out", i), state_dict())
        steps_to_check.append(i)

    # The check, once the program's state is freed.
    del sim
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings, gaps = [], []
    t_ref = time.time()
    for i in steps_to_check:
        if i == 0:
            inp = make_fields(cfg, trf, seed, dev)
            out = keeper.get(("out", 0))
        else:
            inp = {k: v.to(dev) for k, v in keeper.get(("in", i)).items()}
            out = keeper.get(("out", i))
        out = {k: v.to(dev) for k, v in out.items()}
        gen = None
        if particles:
            gen = rng.generator(dev, sim_seed)
            reference.skip_births(int(p["nSamples"]), gen, dev, i)
        ref = reference.erode_step(inp, scale, p, gen)
        gaps.append(check.fields(inp, out, ref))
        readings.append(check.compare(inp, out, ref))
        del inp, out, ref
    numbers = check.worst(readings)
    over = check.judge(numbers, lim)
    ref_s = time.time() - t_ref

    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], traced):
        if traced:
            v = spec.reader(m["name"], here)(rec)
        else:
            rate = W * H * n / res["window_s"]
            v = {"cell_steps_per_s": rate, "cell_steps_per_s.small": rate,
                 "step_ms_p95": _p95(res["intervals_ms"]),
                 "peak_mem_gb": peak / 1e9,
                 "setup_s": setup_s}.get(m["name"])
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
                   "steps_run": warm + res["ran"], "window_s": res["window_s"],
                   "setup_s": setup_s, "reference_s": ref_s,
                   "over_limit": over,
                   "step_ms": _step_summary(res["intervals_ms"]),
                   "field_gaps": check.worst(gaps)}
    if traced:
        out["info"]["traced"] = {"device_ops": len(rec["device_ops"]),
                                 "host_spans": len(rec["host_spans"]),
                                 "counters": rec["counters"],
                                 "profiled_window_s": rec["window_s"]}
    out["checks"] = {k: [_num(numbers[k]), lim[k]] for k in check.NUMBERS}
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
