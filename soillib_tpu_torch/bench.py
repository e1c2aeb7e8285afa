"""Headline benchmark of the port: coupled erosion step throughput
(gridpoint-steps/s) on one card. The counterpart of the JAX package's
`bench.py`, with the same structure and the same JSON keys:

    python -m soillib_tpu_torch.bench [--size N] [--iters 32|auto]
        [--steps 8] [--albedo on|off] [--device cuda|cpu]

The full coupled step (fluvial + debris cohort transport at 32 rounds
each, or `auto`: maxage-2 = 510 rounds with the adaptive exit at
transportTol=1e-6; mass transfer, creep) at 4096^2 on the card (256^2
with --device cpu), on the JAX bench's FastNoiseLite terrain, timed as the
best group of steps. `vs_baseline` is the value over the step's speed of
light, the lower of

  * the memory roofline: the measured stream bandwidth over the
    minimum-traffic byte model of the cohort passes
    (`step_bytes_per_cell`), and
  * the compute roofline: the FP32 rate over the reference round's
    operations (`ROUND_OPS`, weighted by the probe's cost weights).

The FP32 rate is max(probe, spec): the probe is the hand-written kernel
csrc/fp32_chain.cu (the counterpart of the TPU kernel of bench.py's
`_vpu_chain_time`), the spec is SMs x 128 FP32 lanes x the maximum SM
clock. Operations are fma-equivalents, one per instruction, which is
bench.py's unit: an FMA counts once, so the data sheet's FP32 TFLOP/s,
which counts it twice, is not the rate here.

Both ceilings are models of the REFERENCE's work, held as constants so
that no change of the port's kernels moves the yardstick: the operation
counts are bench.py's own counts of the JAX round's jaxpr, and the byte
model fixes the temporal blocking at K = 16 rounds per pass (the JAX
kernel's K at 4096^2 with albedo on). K is a constant of the yardstick,
not the blocking of the port's kernel, which runs one round per launch
(208 / 192 B per cell-round).

Prints ONE JSON line on stdout; on stderr the roofline breakdown and a
`[run]` line: the run's peak device memory (allocated and reserved, GB)
and the kernel launches it made (cohort rounds and the FP32 probe).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from soillib_tpu_torch.core.device import _device

# The reference round's operations per cell, by fma-equivalent weight
# class (simple, exp, div, sqrt), per (rule set, albedo): bench.py's
# `cohort_round_ops` counted from the JAX jaxpr with each class's weight
# set to 1 in turn (tests/test_torch_bench.py recomputes them).
ROUND_OPS = {
    ("fluvial", True): (891.1923828125, 10.0, 33.0, 9.0),
    ("debris", True): (919.2021484375, 14.0, 40.0, 9.0),
    ("fluvial", False): (824.1572265625, 10.0, 33.0, 9.0),
    ("debris", False): (868.1669921875, 14.0, 40.0, 9.0),
}
WEIGHT_CLASSES = ("simple", "exp", "div", "sqrt")

# The same count of the reference round under each closure that runs
# another build of the cohort kernel, per (rule set, albedo, nodes,
# kernel variant tag): ops/cohort.py `kernel_variant(closure, nodes).tag`.
# The node rules reach the fluvial solve only (the debris solve drops the
# nodes); a count covers every node of a cell. tests/test_torch_bench.py
# recomputes them from the JAX jaxpr.
VARIANT_ROUND_OPS = {
    ("fluvial", True, 1, "legacy"): (588.162109375, 10.0, 20.0, 4.0),
    ("debris", True, 1, "legacy"): (616.171875, 14.0, 27.0, 4.0),
    ("fluvial", True, 1, "offstep=off"): (814.1884765625, 10.0, 31.0, 6.0),
    ("debris", True, 1, "offstep=off"): (842.1982421875, 14.0, 38.0, 6.0),
    ("fluvial", True, 1, "offstep=stream"): (1175.2099609375, 10.0, 43.0,
                                             18.0),
    ("debris", True, 1, "offstep=stream"): (1203.2197265625, 14.0, 50.0,
                                            18.0),
    ("fluvial", True, 1, "uniform,xmom,perstream"): (1264.2666015625, 32.0,
                                                     49.0, 21.0),
    ("debris", True, 1, "uniform,xmom,perstream"): (1481.3408203125, 48.0,
                                                    77.0, 21.0),
    ("fluvial", True, 4, "sign"): (4388.67578125, 40.0, 148.0, 36.0),
    ("fluvial", True, 4, "cluster"): (4303.58203125, 40.0, 140.0, 40.0),
    ("fluvial", True, 2, "speed"): (2113.322265625, 20.0, 72.0, 24.0),
}

# The keys of the JSON line, in order: bench.py's, with fp32_* for its
# vpu_* and the card's nvidia-smi name and power limit as `device`.
JSON_KEYS = ("metric", "value", "unit", "vs_baseline", "hbm_sol",
             "compute_sol", "bw_bytes_per_s", "bytes_per_cell_step",
             "fp32_ops_per_s", "fp32_ops_per_cell_step", "device")

# Rounds per pass of the byte model (see the module docstring).
K_ROUNDS_PER_PASS = 16
NSTATE = 10

# FP32 lanes per SM on Hopper (4 sub-partitions x 32).
FP32_LANES_PER_SM = 128

# torch operators counted by `count_round_ops`, by weight class; every
# other operator (views, copies, stacks, pads, fills) is free.
OP_CLASSES = {
    **{n: "simple" for n in (
        "abs", "add", "bitwise_and", "bitwise_not", "bitwise_or", "clamp",
        "clamp_max", "clamp_min", "eq", "ge", "gt", "le", "logical_and",
        "logical_not", "logical_or", "lt", "maximum", "minimum", "mul", "ne",
        "neg", "rsub", "sign", "sub", "where")},
    **{n: "exp" for n in ("exp", "expm1", "log", "pow", "tanh")},
    **{n: "div" for n in ("div", "reciprocal")},
    **{n: "sqrt" for n in ("sqrt", "rsqrt")},
}


def round_ops(costs, albedo_on=True) -> dict:
    """Weighted operations per cell of one fluvial and one debris round:
    simple + sum over exp/div/sqrt of count x cost."""
    out = {}
    for kind in ("fluvial", "debris"):
        simple, *weighted = ROUND_OPS[(kind, albedo_on)]
        out[kind] = simple + sum(n * costs[c] for n, c in
                                 zip(weighted, WEIGHT_CLASSES[1:]))
    return out


def closure_round_ops(costs, kind, albedo_on=True, nodes=1, tag="") -> float:
    """Weighted operations per cell of one round of rule set `kind` with
    `nodes` nodes under the closure whose kernel variant tag is `tag`
    ('' for the default physics and face routing: the default round's
    count times the nodes)."""
    if not tag:
        return round_ops(costs, albedo_on)[kind] * nodes
    simple, *weighted = VARIANT_ROUND_OPS[(kind, albedo_on, nodes, tag)]
    return simple + sum(n * costs[c] for n, c in
                        zip(weighted, WEIGHT_CLASSES[1:]))


def step_bytes_per_cell(iters: int, albedo_on=True) -> float:
    """Minimum device-memory traffic per cell and coupled step (bench.py's
    model) with K_ROUNDS_PER_PASS rounds per pass: each pass reads the
    (NSTATE + C)-channel state, the 4-channel aux and the C deposits,
    writes the state and the deposits, and copies the state back into
    the carry (read + write); plus 40 float32 field touches for the terms,
    the normalization, the transfer and the creep."""

    def cohort(C, A=1):
        S = NSTATE + C
        passes = -(-int(iters) // K_ROUNDS_PER_PASS)
        per_pass = (S + (3 + A) + C) * 4 + (S + C) * 4 + 2 * S * 4
        return passes * per_pass

    rest = 40 * 4
    if albedo_on:
        return float(cohort(7) + cohort(6) + rest)
    return float(cohort(4) + cohort(3) + rest)


def count_round_ops(fn, *args, **kwargs) -> dict:
    """Elements produced by each weight class of operators while fn runs
    (on CPU tensors): {"simple": n, "exp": n, "div": n, "sqrt": n}."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = dict.fromkeys(WEIGHT_CLASSES, 0)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            cls = OP_CLASSES.get(func.overloadpacket.__name__.rstrip("_"))
            if cls is not None:
                counts[cls] += out.numel()
            return out

    with Count():
        fn(*args, **kwargs)
    return counts


def port_round_ops(albedo_on=True) -> dict:
    """Operations per cell of the port's own plain round of each rule set,
    by weight class, on bench.py's counting inputs (ones on an 8 x 128
    grid, default parameters, Llen 0.11)."""
    from soillib_tpu_torch.models import erosion
    from soillib_tpu_torch.models.params import ErosionParams
    from soillib_tpu_torch.ops import cohort

    W, H = 8, 128
    p = ErosionParams()
    p.trackAlbedo = albedo_on
    Llen = 0.11
    out = {}
    for kind, rules in (
            ("fluvial", erosion.make_fluvial_rules(p, Llen, albedo_on)),
            ("debris", erosion.make_debris_rules(p, Llen, 1.0, albedo_on))):
        C = len(rules.classes)
        st = torch.ones((NSTATE + C, W, H))
        G = torch.zeros((C, W, H))
        aux = torch.ones((4, W, H))
        counts = count_round_ops(cohort.cohort_round, st, G, aux, rules,
                                 Llen)
        out[kind] = {k: v / (W * H) for k, v in counts.items()}
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def smi_query(field: str, device) -> str:
    """One nvidia-smi field of the card `device` (raises without one)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader",
         "-i", str(device.index or 0)],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def measure_stream_bw(device, n_bytes=None, reps=50) -> float:
    """Bytes/s of `reps` elementwise passes over an n_bytes float32
    buffer, one read and one write per element and pass (torch.mul into a
    second buffer, ping-pong). 256 MB on the card, 16 MB on the CPU."""
    if n_bytes is None:
        n_bytes = 1 << 28 if device.type == "cuda" else 1 << 24
    n = n_bytes // 4
    a = torch.arange(n, dtype=torch.float32, device=device)
    b = torch.empty_like(a)
    torch.mul(a, 1.0000001, out=b)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.mul(a, 1.0000001, out=b)
        a, b = b, a
    _sync(device)
    return reps * 2 * n * 4 / (time.perf_counter() - t0)


def spec_fp32_rate(device) -> float:
    """FP32 instruction issue slots per second of the card: SMs x 128
    lanes x the maximum SM clock (nvidia-smi clocks.max.sm)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(smi_query("clocks.max.sm", device).split()[0])
    return sms * FP32_LANES_PER_SM * mhz * 1e6


def chain_time(op, reps, x, timings=3) -> float:
    """Seconds of one probe launch (the minimum over `timings` launches
    after one warm-up), timed with CUDA events on the card and on the
    host clock on the CPU."""
    from soillib_tpu_torch.ops import fp32_chain

    out = fp32_chain.chain(x, op, reps)
    best = float("inf")
    for _ in range(timings):
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fp32_chain.chain(x, op, reps)
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            out = fp32_chain.chain(x, op, reps)
            dt = time.perf_counter() - t0
        best = min(best, dt)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"fp32 probe {op}: non-finite chains")
    return best


def measure_fp32(device) -> dict:
    """The FP32 rate and the cost weights of exp/div/sqrt (bench.py's
    `measure_vpu`). rate = max(probe, spec); on the CPU there is no spec
    and the plain chains run 4 rounds."""
    from soillib_tpu_torch.ops import fp32_chain

    n = fp32_chain.probe_elements(device)
    x = torch.full((n,), 0.5, dtype=torch.float32, device=device)
    per_round = fp32_chain.K * fp32_chain.U
    spec = spec_fp32_rate(device) if device.type == "cuda" else 0.0
    # On the card one fma launch runs about 50 ms at the spec rate.
    reps = (max(1, int(spec * 0.05) // (n * per_round)) if spec else 4)
    dt_fma = chain_time("fma", reps, x)
    probe = per_round * n * reps / dt_fma
    # Each op body is the op under test plus one plain op, timed against
    # a body of two plain ops: dt_op / dt_fma2 = (c + 1) / 2.
    half = reps // 2 + 1
    dt_fma2 = chain_time("fma2", half, x)
    costs = {op: max(1.0, 2.0 * chain_time(op, half, x) / dt_fma2 - 1.0)
             for op in ("exp", "div", "sqrt")}
    return {"rate": max(probe, spec), "probe": probe, "spec": spec,
            "costs": costs, "reps": reps, "elements": n,
            "fma_launch_s": dt_fma}


def main(argv=None) -> dict:
    """Run the bench; prints the JSON line and returns it as a dict."""
    import soillib_tpu_torch as soil

    ap = argparse.ArgumentParser(prog="python -m soillib_tpu_torch.bench")
    ap.add_argument("--size", type=int, default=0,
                    help="grid edge (default 4096 on the card, 256 on the "
                         "CPU)")
    ap.add_argument("--iters", default="32",
                    help="transport rounds (int), or 'auto' = maxage-2 = "
                         "510 rounds as the bound with the adaptive exit "
                         "(transportTol=1e-6)")
    ap.add_argument("--steps", type=int, default=8, help="timed steps")
    ap.add_argument("--albedo", choices=("on", "off"), default="on",
                    help="albedo tracking (off: 3 fewer carried channels "
                         "per cohort solve)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = _device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    size = args.size or (4096 if device.type == "cuda" else 256)
    from soillib_tpu_torch.ops import cohort, fp32_chain

    counters = {"cohort": cohort.cohort_round_launches,
                "fp32_chain": fp32_chain.fp32_chain_launches}
    counts0 = {k: dict(c) for k, c in counters.items()}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    W = H = size
    scale = (0.078, 0.078, 4.0)
    height = soil.noise((W, H), soil.noise_t(), device=device) * 0.5 + 1.0
    # Constant fields as broadcastable (1, 1) / (3, 1, 1) tensors, as the
    # JAX bench passes them.
    state = soil.ErosionState.zeros((W, H), height=height, rainfall=1.0,
                                    uplift=0.0,
                                    albedo_bedrock=(1.0, 1.0, 1.0),
                                    albedo_surface=(1.0, 1.0, 1.0),
                                    device=device)
    del height
    param = soil.ErosionParams()
    auto = args.iters == "auto"
    if auto:
        param.transportIterations = 0
        param.transportTol = 1e-6
        iters_n = max(param.maxage - 2, 1)
    else:
        param.transportIterations = iters_n = int(args.iters)
    albedo_on = args.albedo == "on"
    param.trackAlbedo = albedo_on
    step = soil.make_erode_fn(param, scale, steps=1)

    def shapes(st):
        return tuple(tuple(getattr(st, f).shape)
                     for f in st.__dataclass_fields__)

    # Warm up (the first step builds the kernels) until the state's
    # shapes settle: with albedo tracked the first step broadcasts the
    # (3, 1, 1) albedo fields to full size.
    for _ in range(3):
        before = shapes(state)
        state = step(state)
        _sync(device)
        if shapes(state) == before:
            break

    groups = max(1, args.steps // 4)
    per_group = args.steps // groups
    group_s = []
    for _ in range(groups):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(per_group):
            state = step(state)
        _sync(device)
        group_s.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(state.layers).all()):
        raise AssertionError("bench: non-finite heights after the timed steps")
    value = per_group * W * H / min(group_s)

    bw = max(measure_stream_bw(device) for _ in range(3))
    nbytes = step_bytes_per_cell(iters_n, albedo_on)
    hbm_sol = bw / nbytes
    fp32 = measure_fp32(device)
    ops = round_ops(fp32["costs"], albedo_on)
    ops_per_cell_step = (ops["fluvial"] + ops["debris"]) * iters_n
    compute_sol = fp32["rate"] / ops_per_cell_step
    sol = min(hbm_sol, compute_sol)
    port = port_round_ops(albedo_on)

    def unit(d):
        return sum(d.values())

    print(
        f"[roofline] stream bw {bw / 1e9:.0f} GB/s, bytes/cell-step "
        f"{nbytes:.0f} -> memory SoL {hbm_sol / 1e6:.1f} M/s | FP32 "
        f"{fp32['rate'] / 1e12:.2f} Top/s (probe "
        f"{fp32['probe'] / 1e12:.2f}, spec {fp32['spec'] / 1e12:.2f}; exp "
        f"{fp32['costs']['exp']:.1f}, div {fp32['costs']['div']:.1f}, sqrt "
        f"{fp32['costs']['sqrt']:.1f} fma-eq), round ops/cell: fluvial "
        f"{ops['fluvial']:.0f} + debris {ops['debris']:.0f} -> compute SoL "
        f"{compute_sol / 1e6:.1f} M/s | binding: "
        f"{'memory' if hbm_sol < compute_sol else 'compute'} | port's plain "
        f"round, unit weights: fluvial {unit(port['fluvial']):.1f} "
        f"(reference {sum(ROUND_OPS[('fluvial', albedo_on)]):.1f}), debris "
        f"{unit(port['debris']):.1f} (reference "
        f"{sum(ROUND_OPS[('debris', albedo_on)]):.1f}) | groups of "
        f"{per_group} steps: {[round(t, 4) for t in group_s]} s",
        file=sys.stderr, flush=True,
    )
    launches = {k: {n: v - counts0[k].get(n, 0) for n, v in c.items()
                    if v != counts0[k].get(n, 0)}
                for k, c in counters.items()}
    peak = ("peak memory allocated "
            f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB, "
            f"reserved {torch.cuda.max_memory_reserved(device) / 1e9:.2f} GB"
            if device.type == "cuda" else "peak memory not measured (cpu)")
    print(f"[run] {peak}; launches {json.dumps(launches)}", file=sys.stderr,
          flush=True)
    depth = f"auto(<={iters_n})" if auto else str(iters_n)
    device_desc = (smi_query("name,power.limit", device)
                   if device.type == "cuda" else "cpu")
    out = {
        "metric": f"coupled erosion grid-point-steps/s/card @{W}x{H}, "
                  f"{depth} transport rounds",
        "value": round(value, 1),
        "unit": "gridpoint-steps/s",
        "vs_baseline": round(value / sol, 4),
        "hbm_sol": round(hbm_sol, 1),
        "compute_sol": round(compute_sol, 1),
        "bw_bytes_per_s": round(bw, 1),
        "bytes_per_cell_step": round(nbytes, 1),
        "fp32_ops_per_s": round(fp32["rate"], 1),
        "fp32_ops_per_cell_step": round(ops_per_cell_step, 1),
        "device": device_desc,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
