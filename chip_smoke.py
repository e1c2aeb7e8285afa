#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (soillib_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from soillib_tpu_torch/csrc (one nvcc per source,
in parallel), holds each against its plain torch version on the card, and
drives these paths through the public entry points, at full width (4096^2)
unless stated: the coupled erosion step (32 cohort rounds), the DEM
workload (fill_depressions -> steepest -> accumulate and accumulate_decay
through the tile kernels -> gradient -> solve_uniform through the sweep
kernel, 8192 rounds at 8 a launch), the erosion step with
transportMethod="field-static" (the sweep kernel at C = 7), the fractal
noise, the headline bench (`python -m soillib_tpu_torch.bench` at 32
rounds and `auto`, which runs the FP32 probe kernel), the flagship
example at 1024^2 and the quality closure CohortClosure(nodes=4,
colors=8) (the cohort kernel with
NODES=4, once per color group and round), then reverse mode through the
kernels (a 256^2 coupled step and a 1024^2 accumulate_decay, gradients
against the plain path's on the card), the multiscale cascade at the
reference's levels (128^2 x 2048 steps, 256^2 x 4, 1000^2 x 4; the
cohort solves of each level's first and last step held bitwise against
the plain rounds), the 128^2 x 30-step trajectory golden of
tests/test_golden.py on the card, and the DEM and TIFF examples
(dem_process 1024^2, dem_condition 512^2, dem_multiflow 1024^2 with 512
members; the kernel calls of dem_process and of one dem_multiflow batch
held bitwise against plain, and the tile kernels at 1000^2 and 1000 x
744; tiff_merge, tiff_mesh and tiff_view on two 1024^2 tiles the phase
writes), and every closure variant of the cohort kernel (the legacy
split, offstep off and per stream, uniform streams with xmom and
perstream; sign, cluster and speed node routing: each variant's library
built at its first use, its kernels held against the plain round at
512^2, its fluvial gradient against the plain path's, and two 4096^2
coupled steps with the closure), then the Monte-Carlo particle path
(transportMethod="particles": a 4096^2 step with one particle a cell at
127 rounds, the reference flagship's 256^2 / 8192 particles / 255
rounds for 32 steps and held against the CPU with the same injected
births, the trajectory kernel against the plain loop at that size, both
estimators, timed, and dem_process --particles at 1024^2 with its
tile-kernel calls bitwise) and the host utilities (a 4096^2 checkpoint round trip,
prefetch of 16 GeoTIFF tiles through a side stream, the native
library's build and LZW decode), then sharded execution
(soillib_tpu_torch.parallel, phase 21) in ranks spawned by
parallel.launch: a 1 x 1 mesh over NCCL at 1024^2 (two steps, each
bitwise equal to erode's), and four ranks sharing the card over
host-staged gloo as a 2 x 2 mesh: the 4096^2 headline step against the
single-device step (every cohort call of rank 0 bitwise against the
plain rounds on its padded block; ms a step per rank, the exchanges'
share, the halo bytes, peak memory), the pod examples at their defaults
(erosion_pod 1024^2 x 64 steps; dem_mc_pod 256^2 with 1,048,576
particles against the single-device estimators), the distributed
accumulate of the DEM path's 4096^2 graph (every tile call of rank 0
bitwise) and the sharded solve_uniform at 1024^2 (bitwise, every sweep
call of rank 0 bitwise), then the compiled driver (phase 22: make_erode_fn
replaying one step captured as a CUDA graph, against the eager erode_step,
bitwise with equal launch counters, in seven configurations from the
bench's 4096^2 to the cascade's 128^2 level and the flagship's particle
step; ms a step of both, the compiled step's phases and idle share inside
its graph read through its marks, capture time and peak memory), then
the study harnesses of soillib_tpu_torch.benchmarks (phase 23: the
transport-parity harness at 256^2 on the noise and steep terrains, 4
seeds, cold and warm, 4 coupled steps x 2, its keys the JAX harness's,
its metrics finite and every eager field solve bitwise against the plain
rounds, and the age-deficit probe's 126 one-round kernel launches at
48^2 bitwise against the plain rounds' trace; phase 24: the weak-scaling
harness with 1 and 4 ranks sharing the card, block 1024, 32 rounds, the
4 ranks' timed step bitwise against the single-device step), then
phase 25: the bench at the JAX headline's capacity configuration (8192^2,
albedo off, 32 rounds, 4 timed steps) in-process, its keys and its
1200-byte yardstick, and the cohort kernel built with ALBEDO=false
(fluvial and debris) held bitwise against the plain round at 1 and 16
rounds on that run's own cohort inputs and timed per round there. The
erosion paths of every phase run the compiled driver; where a phase
records a kernel's inputs it calls the eager erode_step. Each path's
kernel launches
are counted from zero just before it runs and read just after; one more
step of each erosion path is profiled and read through the phase marks
captured into its graph (perfbench/marks.py), and one accumulate is
profiled by kernel.
Every phase raises on failure. The last three lines of standard output are a JSON object
describing each kernel (its launches on its path, its error against the
plain version on the path's own inputs, its time, the plain version's
time and its bound), the card's name and power limit, and the final
status line {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device.

Imports torch, numpy and the port; never JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

# Published H100 SXM HBM bandwidth (NVIDIA data sheet).
PEAK_BYTES_PER_S = 3.35e12
# FP32 instructions per second outside the tensor cores: SMs x 128 lanes x
# the maximum SM clock of this card (soillib_tpu_torch.bench
# `spec_fp32_rate`), set by main. Operations are counted one per
# elementwise op and the kernels are built with -fmad=false, so the data
# sheet's FP32 TFLOP/s, which counts an FMA as two, would halve the bound.
PEAK_F32_PER_S = None


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import torch

    from soillib_tpu_torch import bench

    return bench.smi_query("name,power.limit",
                           torch.device("cuda", torch.cuda.current_device()))


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over `reps` calls (one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def terrain(n, seed, device="cuda"):
    """Smooth seeded terrain: bilinear-upsampled random octaves (numpy
    draws, upsampled on the card), height ~ 2 +- 0.5 as the golden tests
    use."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    h = torch.zeros((n, n), dtype=torch.float32, device=device)
    amp, total = 1.0, 0.0
    for k in range(3, 9):  # 8^2 ... 256^2 control grids
        m = 2 ** k
        c = torch.from_numpy(rng.uniform(-1.0, 1.0, (1, 1, m, m))
                             .astype(np.float32)).to(device)
        h += amp * F.interpolate(c, size=(n, n), mode="bilinear",
                                 align_corners=True)[0, 0]
        total += amp
        amp *= 0.5
    return 2.0 + 0.5 * h / total


def cohort_problem(kind, albedo, n, seed, device):
    """Seeded cohort state/aux (the JAX kernel tests' recipe,
    soillib_tpu_torch.testing `cohort_arrays`) and the real rule set of
    `kind`."""
    import torch

    from soillib_tpu_torch.models import erosion
    from soillib_tpu_torch.models.params import ErosionParams
    from soillib_tpu_torch.testing import cohort_arrays

    st, aux = cohort_arrays(kind, albedo, n, n, seed)
    p = ErosionParams()
    Llen = math.sqrt(0.02)
    if kind == "fluvial":
        rules = erosion.make_fluvial_rules(p, Llen, albedo)
    else:
        rules = erosion.make_debris_rules(p, Llen, p.nSamples / n / n, albedo)
    return (torch.from_numpy(st).to(device), torch.from_numpy(aux).to(device),
            rules, Llen)


def check_close(name, got, want, rtol, atol):
    """Max abs error of got against want; raises unless every element is
    within atol + rtol * |want| (atol may be a tensor that broadcasts)."""
    import torch

    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol {rtol} and the "
            f"stated atol; max abs err {float(err.max()):.3e}")
    return float(err.max())


def phase_kernel_vs_plain(n=512):
    """Each kernel against its plain torch version on the card, on seeded
    states of every rule set, albedo on and off."""
    import torch

    from soillib_tpu_torch.ops import cohort

    for kind in ("fluvial", "debris"):
        for albedo in (True, False):
            st, aux, rules, Llen = cohort_problem(kind, albedo, n, 1, "cuda")
            C = st.shape[0] - cohort.NSTATE
            G = torch.zeros((C, n, n), device="cuda")
            st_k = cohort.cohort_round_cuda(st, aux, G, rules, Llen)
            st_p, G_p = cohort.cohort_round(st, torch.zeros_like(G), aux,
                                            rules, Llen)
            torch.cuda.synchronize()
            e1 = check_close(f"{kind} albedo={albedo} 1-round state",
                             st_k, st_p, 2e-6, 1e-5)
            e2 = check_close(f"{kind} albedo={albedo} 1-round deposits",
                             G, G_p, 2e-6, 1e-5)
            _, g_k = cohort.cohort_advance_cuda(st, aux, rules, 16, Llen)
            _, g_p = cohort.cohort_advance_reference(st, aux, rules, 16, Llen)
            torch.cuda.synchronize()
            # rtol 2e-5: the JAX kernel tests' multi-round bar
            # (tests/test_sweep.py::test_cohort_kernel_multitile).
            e3 = check_close(f"{kind} albedo={albedo} 16-round deposits",
                             g_k, g_p, 2e-5, 1e-5)
            log(f"  {kind:7s} albedo={int(albedo)} {n}^2: max abs err "
                f"1 round state {e1:.3e} deposits {e2:.3e}; 16 rounds "
                f"deposits {e3:.3e}")


def finite_state(state, what):
    import dataclasses

    import torch

    for f in dataclasses.fields(state):
        a = getattr(state, f.name)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: non-finite values in {f.name}")


def phase_main_path(n=4096, steps=3, iters=32):
    """ErosionSim at full width through the kernel; returns the sim and
    the step times."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.ops import cohort

    p = soil.ErosionParams()
    p.transportIterations = iters
    p.trackAlbedo = True
    scale = (0.1, 0.1, 4.0)
    state = soil.ErosionState.zeros((n, n), height=terrain(n, 7))
    sim = soil.ErosionSim((n, n), scale, p, state=state)
    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = nonzero(cohort.cohort_round_launches)
    rounds = nonzero(cohort.cohort_rounds)
    finite_state(sim.state, f"{n}^2 erode")
    if (tuple(sim.state.layers.shape) != (2, n, n)
            or tuple(sim.state.discharge.shape) != (n, n)):
        raise AssertionError("erode changed the state's shapes")
    want = steps * iters
    split = steps * len(cohort.launch_rounds(iters,
                                             cohort.ROUNDS_PER_LAUNCH))
    if (rounds != {"fluvial": want, "debris": want}
            or launches != {"fluvial": split, "debris": split}):
        raise AssertionError(
            f"rounds {rounds} in launches {launches}, expected {want} "
            f"rounds in {split} launches per rule set ({steps} steps x "
            f"{iters} rounds)")
    return sim, times, launches


def capture_solves(sim):
    """The cohort solve inputs of one more step of `sim` (st, aux, rules,
    Llen per rule set), recorded at the dispatch point of an eager
    `erode_step` (a replayed step calls no Python)."""
    from soillib_tpu_torch.models.simulation import erode_step
    from soillib_tpu_torch.ops import cohort

    captured = {}
    run = cohort.run_cohort

    def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        captured[rules.kind] = (cohort.as_stack(st0).contiguous(),
                                cohort.as_stack(aux).contiguous(), rules,
                                Llen)
        return run(st0, aux, rules, iters, Llen, closure, tol)

    cohort.run_cohort = spy
    try:
        sim.state = erode_step(sim.state, sim.scale, sim.param, sim.key)
    finally:
        cohort.run_cohort = run
    return captured


def ptxas_usage(kernel, kind, albedo, nodes=1, defines=()):
    """(registers, static shared bytes, spill store bytes, spill load
    bytes) that ptxas reported for one instantiation of a cohort kernel,
    from the build log of the library built with `defines`; None if the
    log does not name it."""
    import re

    from soillib_tpu_torch import _native

    tmpl = f"ILi{0 if kind == 'fluvial' else 1}ELb{int(albedo)}E" + (
        f"Li{nodes}E" if nodes > 1 else "")
    lines = _native.build_log("cohort_round", defines).splitlines()
    for i, line in enumerate(lines):
        if f"{kernel}{tmpl}" in line and "Compiling entry" in line:
            spills = (0, 0)
            for used in lines[i + 1:i + 4]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", used)
                if m:
                    spills = (int(m[1]), int(m[2]))
                m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                              used)
                if m:
                    return int(m[1]), int(m[2] or 0), *spills
    return None


def design_bytes_per_cell_round(geo, S, C):
    """Device-memory bytes per owned cell and round of the kernel's own
    design: every cell of a block (its ring included) reads the state and
    aux once per launch, owned cells read and write the deposits and
    write the state."""
    cols, rows = geo.block
    own = (geo.cluster * rows - 2 * geo.ring) * (cols - 2 * geo.ring)
    cells = geo.cluster * rows * cols
    return 4 * (cells * (S + 4) + own * (C + S + C)) / (own * geo.rounds)


def set_round_bound(entry, ops_per_cell, bytes_per_cell_pass):
    """The least time of one round at the entry's shape: the larger of
    the weighted operations over the FP32 issue rate and the state, aux
    and deposits moved once per K_ROUNDS_PER_PASS rounds (each read once,
    each written once, as the reference's passes do) over the HBM rate.
    Both hold whatever implements the round."""
    from soillib_tpu_torch import bench

    cells = math.prod(entry["shape"][1:])
    ops_ms = ops_per_cell * cells / PEAK_F32_PER_S * 1e3
    bytes_ms = (bytes_per_cell_pass / bench.K_ROUNDS_PER_PASS * cells
                / PEAK_BYTES_PER_S * 1e3)
    entry.update(bound_ms=max(ops_ms, bytes_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
                 ops_per_cell_round=ops_per_cell,
                 bound_bytes_per_cell_pass=bytes_per_cell_pass)


def cohort_bound(entry, costs):
    """`set_round_bound` of a cohort entry: the reference round's
    operations under the entry's closure (bench.closure_round_ops, counted
    from the JAX round, weighted by the probe's costs);
    4 x ((S + 4 + C) + (S + C)) bytes per pass."""
    from soillib_tpu_torch import bench

    S, C = entry["shape"][0], entry["carried"]
    ops = bench.closure_round_ops(costs, entry["kind"], entry["albedo"],
                                  entry["nodes"], entry["variant"])
    set_round_bound(entry, ops, 4 * ((S + 4 + C) + (S + C)))


def round_checks(what, st, aux, rules, Llen, closure=None, rounds=16):
    """The cohort kernel built for `closure` against the plain round on
    (st, aux): one round, state and deposits bitwise; `rounds` rounds
    through the wrapper's split, state and deposits bitwise for one node,
    deposits at rtol 2e-5 / atol 1e-5 for N nodes (the JAX kernel tests'
    multi-round bar). Returns the max abs errors of 1 and of `rounds`
    rounds."""
    import torch

    from soillib_tpu_torch.ops import cohort

    nodes = closure.nodes if closure is not None else 1
    C = cohort.n_deposits(st.shape[0], closure)
    G = torch.zeros((C,) + tuple(st.shape[1:]), device=st.device)
    st_k = cohort.cohort_round_cuda(st, aux, G, rules, Llen, nodes=nodes,
                                    closure=closure)
    st_p, G_p = cohort.cohort_round(st, torch.zeros_like(G), aux, rules,
                                    Llen, closure)
    err = max(bitwise_err(f"{what}, 1-round state", st_k, st_p),
              bitwise_err(f"{what}, 1-round deposits", G, G_p))
    del st_k, st_p, G_p, G
    st_k, g_k = cohort.cohort_advance_cuda(st, aux, rules, rounds, Llen,
                                           closure=closure)
    st_p, g_p = cohort.cohort_advance_reference(st, aux, rules, rounds, Llen,
                                                closure=closure)
    if nodes == 1:
        return err, max(
            bitwise_err(f"{what}, {rounds}-round state", st_k, st_p),
            bitwise_err(f"{what}, {rounds}-round deposits", g_k, g_p))
    return err, check_close(f"{what}, {rounds}-round deposits", g_k, g_p,
                            2e-5, 1e-5)


def kernel_entry(kind, captured, launches, closure=None, crop=2048):
    """One cohort kernel's line of the report at a path's inputs
    (captured[kind]), for the library built for `closure` (None: the
    default closure's): the kernel against the plain round
    (`round_checks`), then both timed, the kernel per round over launches
    of ROUNDS_PER_LAUNCH rounds (N nodes: one round a launch). One node
    is checked on the path's inputs; N nodes on a crop^2 corner of them,
    where the plain round's temporaries (about 15 times the state) fit
    beside the path's buffers, and the plain round is timed there. The
    bound is set once the probe's costs exist (`cohort_bound`)."""
    import torch

    from soillib_tpu_torch.ops import cohort

    st, aux, rules, Llen = captured[kind]
    nodes = closure.nodes if closure is not None else 1
    v = cohort.kernel_variant(closure, nodes)
    key = cohort.launch_key(kind, nodes, v.tag)
    S, W, H = st.shape
    C = cohort.n_deposits(S, closure)
    K = cohort.ROUNDS_PER_LAUNCH if nodes == 1 else 1
    saved = dict(cohort.cohort_round_launches), dict(cohort.cohort_rounds)
    sc, ac = st, aux
    if nodes > 1:
        sc = st[:, :crop, :crop].contiguous()
        ac = aux[:, :crop, :crop].contiguous()
    what = f"{key} {'x'.join(map(str, sc.shape))} " + (
        "main-path inputs" if nodes == 1 else "crop of the path's inputs")
    err, err16 = round_checks(what, sc, ac, rules, Llen, closure)
    log(f"  {what}: 1 round and 16 rounds ({K} a launch) "
        f"{'bitwise equal' if nodes == 1 else 'bitwise / within rtol 2e-5'}"
        f" (max abs err {err16:.3e})")
    G = torch.zeros((C, W, H), device="cuda")
    out = torch.empty_like(st)

    def launch(x, a, g, k):
        return cohort.cohort_rounds_cuda(x, a, g, rules, Llen, k, out=out,
                                         nodes=nodes, closure=closure)

    ms = cuda_ms(lambda: launch(st, aux, G, K), 20) / K
    extra = {}
    if nodes == 1:
        extra["ms_per_round_at_1_round_a_launch"] = cuda_ms(
            lambda: launch(st, aux, G, 1), 20)
    del G, out
    Gc = torch.zeros((C,) + tuple(sc.shape[1:]), device="cuda")
    if nodes > 1:
        out = torch.empty_like(sc)
        extra["ms_at_plain_shape"] = cuda_ms(lambda: launch(sc, ac, Gc, 1),
                                             10)
        del out
    plain_ms = cuda_ms(lambda: cohort.cohort_round(sc, Gc, ac, rules, Llen,
                                                   closure), 3)
    # Launches made to compare and time the kernel do not count.
    for counts, before in zip((cohort.cohort_round_launches,
                               cohort.cohort_rounds), saved):
        counts.clear()
        counts.update(before)
    geo = cohort.kernel_geometry(C, nodes, W, H, K, v.rule)
    usage = ptxas_usage("cohort_rounds_kernel" if nodes == 1
                        else "cohort_round_nodes_kernel", kind,
                        rules.albedo_on, nodes, v.defines())
    return {
        "name": f"cohort_round[{key}]",
        "route": "cuda",
        "source": "soillib_tpu_torch/csrc/cohort_round.cu",
        "replaces": "soillib_tpu/ops/cohort.py:1480",
        "launches": launches[key],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": None,
        "bound_by": None,
        "library_ms": None,
        "shape": [S, W, H],
        "kind": kind,
        "albedo": bool(rules.albedo_on),
        "nodes": nodes,
        "variant": v.tag,
        "variant_defines": list(v.defines()),
        "carried": C,
        "plain_shape": list(sc.shape),
        "max_abs_err_16_rounds": err16,
        "rounds_per_launch": K,
        **extra,
        "tile": {"block": list(geo.block), "ring": geo.ring,
                 "cluster": geo.cluster,
                 "owned": [geo.cluster * geo.block[1] - 2 * geo.ring,
                           geo.block[0] - 2 * geo.ring]},
        "registers": usage and usage[0],
        "spill_store_bytes": usage and usage[2],
        "spill_load_bytes": usage and usage[3],
        "shared_bytes_per_block": geo.smem + (usage[1] if usage else 0),
        "bytes_per_cell_round": design_bytes_per_cell_round(geo, S, C),
    }


def phase_kernel_vs_plain_erode(n=256, steps=2, iters=32):
    """A whole erode through the kernel (card) against the plain path
    (CPU), on field statistics at the golden tests' rtol."""
    import soillib_tpu_torch as soil

    h = terrain(n, 11).cpu().numpy()
    p = soil.ErosionParams()
    p.transportIterations = iters
    out = {}
    for dev in ("cuda", "cpu"):
        st = soil.ErosionState.zeros((n, n), height=h, device=dev)
        out[dev] = soil.erode(st, (0.1, 0.1, 4.0), p, steps=steps)
    for name in ("height", "discharge", "sediment"):
        k = getattr(out["cuda"], name).cpu().numpy()
        c = getattr(out["cpu"], name).numpy()
        sk = np.array([k.mean(), k.std(), np.abs(k).max()])
        sc = np.array([c.mean(), c.std(), np.abs(c).max()])
        np.testing.assert_allclose(sk, sc, rtol=1e-3, err_msg=name)
        log(f"  {name:9s} stats kernel {sk} plain {sc} max rel "
            f"{np.max(np.abs(sk - sc) / np.abs(sc)):.2e}")


def phase_faithful_depth(n=1024):
    """transportIterations=0 (maxage-2 = 510 rounds) with the adaptive
    exit, one eager `erode_step` (phase 22 holds the compiled step to it).
    The kernel path checks the exit every TOL_CHECK_ROUNDS rounds,
    the plain path every round: each solve of the step is rerun on the
    plain path on the card, and the kernel must have run the plain exit
    round rounded up to the next check (at most the bound), with deposits
    within the multi-round bar (rtol 2e-5, atol 1e-5) plus what the extra
    rounds may add, tol times the channel's deposit gauge."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.models.simulation import erode_step
    from soillib_tpu_torch.ops import cohort

    p = soil.ErosionParams()
    p.transportIterations = 0
    p.transportTol = 1e-6
    st = soil.ErosionState.zeros((n, n), height=terrain(n, 13))
    solves = {}
    run = cohort.run_cohort

    def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        n0 = cohort.cohort_rounds[rules.kind]
        g = run(st0, aux, rules, iters, Llen, closure, tol)
        solves[rules.kind] = (cohort.as_stack(st0), cohort.as_stack(aux),
                              rules, int(iters), Llen, tol, g.clone(),
                              cohort.cohort_rounds[rules.kind] - n0)
        return g

    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    cohort.run_cohort = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = erode_step(st, (0.1, 0.1, 4.0), p)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        cohort.run_cohort = run
    finite_state(st, f"{n}^2 faithful-depth erode")
    rounds = nonzero(cohort.cohort_rounds)
    log(f"  {n}^2 transportTol=1e-6, bound {p.maxage - 2} rounds: rounds "
        f"run {rounds} in launches "
        f"{nonzero(cohort.cohort_round_launches)}; step {ms:.1f} ms")

    plain_round = cohort.cohort_round
    for kind in ("fluvial", "debris"):
        st0, aux, rules, iters, Llen, tol, g_k, r_k = solves[kind]
        count = [0]

        def counted(*a, **kw):
            count[0] += 1
            return plain_round(*a, **kw)

        cohort.cohort_round = counted
        try:
            _, g_p = cohort.cohort_advance_reference(st0, aux, rules, iters,
                                                     Llen, tol=tol)
        finally:
            cohort.cohort_round = plain_round
        every = cohort.TOL_CHECK_ROUNDS
        want = min(iters, -(-count[0] // every) * every)
        if r_k != want:
            raise AssertionError(
                f"{kind}: kernel path ran {r_k} rounds; the plain path "
                f"exits after {count[0]}, so {want} were due")
        tail = tol * cohort.deposit_gauge(g_p)[:, None, None]
        err = check_close(f"{kind} {n}^2 adaptive deposits", g_k, g_p, 2e-5,
                          1e-5 + tail)
        log(f"  {kind:7s} rounds kernel {r_k}, plain exit {count[0]}; "
            f"deposits max abs err {err:.3e}")
    return rounds, ms


def idle_share(busy_ms, wall_ms, what):
    """1 - busy / wall, not clipped: a negative share (more device time
    than the wall time it is read against) is reported as inconsistent."""
    share = 1.0 - busy_ms / wall_ms
    if share < 0.0:
        log(f"  {what}: device busy {busy_ms:.3f} ms exceeds the wall time "
            f"{wall_ms:.3f} ms it is read against; the idle share {share:.4f}"
            f" is inconsistent")
    return share


def mark_reading(step, steps=2):
    """`steps` calls of `step()` under torch.profiler
    (`perfbench.trace.profiled_steps`), read through the phase marks that
    the port captures into its step's graph (`perfbench.marks.summary`):
    the mean step span, each phase's ms and the device's idle share
    inside the graph. None where no complete mark group was traced (an
    eager step has none). Two calls: a fresh profiler session may miss
    the first kernel of the first replay it traces."""
    import torch

    from perfbench import marks, trace

    dev = torch.device("cuda", torch.cuda.current_device())
    return marks.summary(trace.profiled_steps(step, steps, dev, dict))


def phase_breakdown(sim, steps=2):
    """Where a step of `sim` goes: one unprofiled step (a step not
    compiled yet captures here) and one timed, then `steps` under
    torch.profiler read through the marks (`mark_reading`), beside the
    unprofiled step's ms."""
    sim.step()
    _, step_ms = timed(sim.step)
    out = mark_reading(sim.step, steps)
    if out is None:
        log("  no complete mark group traced: breakdown not measured")
        return None
    out["unprofiled_step_ms"] = step_ms
    log("  " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The DEM flow and transport path, and the field-static erosion step
# ---------------------------------------------------------------------------


def timed(fn):
    """(fn(), milliseconds) on the host clock between two synchronises."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class Spy:
    """While active, records (args, result) of every call of
    module.name, which is still called through."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def spy(*args):
            out = real(*args)
            self.calls.append((args, out))
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def zero_counts(*counts):
    """Sets each count to 0."""
    for c in counts:
        for k in c:
            c[k] = 0


def nonzero(counts):
    """The entries of a launch-count dict that are not 0."""
    return {k: v for k, v in counts.items() if v}


def phase_dem(n=4096, seed=17):
    """The DEM workload (the reference's dem_process) at n^2 through the
    public entry points: fill_depressions -> steepest -> accumulate and
    accumulate_decay (tiled: the tile kernels) -> gradient -> solve_uniform
    at its default W+H rounds (the sweep kernel, C = 1). Checks shapes,
    finiteness and the mass balance of unit rain; returns the op times,
    the launches and each kernel call's inputs and outputs."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.ops import graph_tiled as gt
    from soillib_tpu_torch.ops import sweep

    h = terrain(n, seed) * 400.0       # 600-1000 m, as dem_process's noise
    scale = (90.0, 90.0)
    rain = torch.ones((n, n), device="cuda")
    ops = {}
    zero_counts(gt.tile_launches, sweep.sweep_launches, sweep.sweep_rounds)
    with Spy(gt, "local_fp_cuda") as loc, Spy(gt, "trace_cuda") as tr, \
            Spy(sweep, "transport_advance_cuda") as sw:
        filled, ops["fill_depressions"] = timed(
            lambda: soil.fill_depressions(h))
        flow, ops["steepest"] = timed(lambda: soil.steepest(filled, soil.d8))
        # The process's first accumulate, its helpers timed (a synchronise
        # around each): where a cold call's time goes.
        with SegmentTimer(accumulate_segments()) as cold:
            area, ops["accumulate"] = timed(
                lambda: soil.accumulate(flow, rain, soil.d8))
        decayed, ops["accumulate_decay"] = timed(
            lambda: soil.accumulate_decay(flow, rain, 0.9999, soil.d8))
        grad, ops["gradient"] = timed(lambda: soil.gradient(filled, scale))
        velocity = -grad / torch.clamp(
            torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-6)
        evap = torch.full((n, n), 0.001, device="cuda")
        discharge, ops["solve_uniform"] = timed(
            lambda: soil.solve_uniform(velocity, rain, evap, scale))
    launches = {"local": gt.tile_launches["local"],
                "trace": gt.tile_launches["trace"],
                "sweep": sweep.sweep_launches["round"],
                "sweep_rounds": sweep.sweep_rounds["round"]}
    for name, a in (("filled", filled), ("area", area),
                    ("decayed", decayed), ("gradient", grad),
                    ("discharge", discharge)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"DEM path: non-finite values in {name}")
    if (flow.dtype != torch.int32 or tuple(flow.shape) != (n, n)
            or tuple(discharge.shape) != (n, n)):
        raise AssertionError("DEM path: unexpected output types or shapes")
    roots = flow < 0
    total = float(area[roots].double().sum())
    if abs(total - n * n) > 1e-4 * n * n:
        raise AssertionError(f"DEM path: unit rain reaching the roots "
                             f"{total} != {n * n} cells")
    want = {"local": 4, "trace": 2,
            "sweep": len(sweep.sweep_launch_rounds(2 * n)),
            "sweep_rounds": 2 * n}
    if launches != want:
        raise AssertionError(f"DEM path launches {launches}, expected {want}")
    log(f"  op ms {json.dumps({k: round(v, 1) for k, v in ops.items()})}; "
        f"launches {launches}; roots {int(roots.sum())} receive "
        f"{total:.0f} of {n * n} cells' rain")
    return {"ops_ms": ops, "launches": launches, "local": loc.calls,
            "trace": tr.calls, "sweep": sw.calls, "flow": flow,
            "rain": rain, "area": area, "decayed": decayed,
            "accumulate_cold_segments_ms": cold.ms}


def bitwise_err(name, got, want):
    """Max abs difference of got and want; raises unless they are bitwise
    equal."""
    import torch

    g = got.contiguous().view(torch.int32)
    w = want.contiguous().view(torch.int32)
    diff = float((got.double() - want.double()).abs().max())
    if not torch.equal(g, w):
        bad = int((g != w).sum())
        raise AssertionError(f"{name}: {bad} elements differ from the plain "
                             f"version (max abs {diff:.3e})")
    return diff


def tile_call_errs(what, kind, calls):
    """Each recorded call (`Spy`) of a tile kernel's wrapper, kind "local"
    (the push) or "trace", against its plain full-grid fixed point on the
    same inputs, bitwise. Returns the max abs errors and the plain
    versions' ms, one each a call."""
    from soillib_tpu_torch.ops import graph_tiled as gt

    errs, plain_ms = [], []
    for i, (args, out) in enumerate(calls):
        if kind == "local":
            lslot, src, w, edge, iters = args
            want, ms = timed(lambda: gt.local_fp_plain(lslot, src, w, edge,
                                                       iters))
            errs.append(bitwise_err(f"{what} local push, call {i}", out[0],
                                    want))
        else:
            slot, w, edge, iters = args
            _, cross = gt._local_slot(*slot.shape, slot, edge)
            recv = gt._pull(torch_arange_grid(slot), slot, edge, 0)
            want, ms = timed(lambda: gt.trace_plain(slot, cross, recv, w,
                                                    edge, iters))
            errs.append(bitwise_err(f"{what} trace X, call {i}", out[0],
                                    want[0]))
            errs.append(bitwise_err(f"{what} trace D, call {i}", out[1],
                                    want[1]))
        plain_ms.append(ms)
        del want
    return errs, plain_ms


def sweep_call_errs(what, calls):
    """Each recorded call (`Spy`) of `transport_advance_cuda` against the
    plain rounds on the same inputs at the call's full depth, bitwise."""
    from soillib_tpu_torch.ops import sweep

    return [bitwise_err(f"{what} sweep, call {i} ({args[-1]} rounds)", out,
                        sweep.transport_advance_reference(*args))
            for i, (args, out) in enumerate(calls)]


def tile_entries(dem):
    """The two tile kernels against their plain full-grid fixed points,
    bitwise, on every input the DEM path gave them (phases 1 and 4 of both
    accumulations; phase 2 of both), then timed on accumulate's own phase
    1/2 inputs. Returns their report lines."""
    from soillib_tpu_torch.ops import graph_tiled as gt

    saved = dict(gt.tile_launches)
    entries = []
    for kind in ("local", "trace"):
        errs, plain_ms = tile_call_errs("DEM path", kind, dem[kind])
        args, out = dem[kind][0]
        # Per tile: the dependency depth (>= 0) where the schedule ran, or
        # minus the Jacobi rounds where the tile took that branch.
        rounds = out[-1].cpu()
        depth = rounds[rounds >= 0].float()
        jacobi = int((rounds < 0).sum())
        W, H = args[0].shape
        fn = gt.local_fp_cuda if kind == "local" else gt.trace_cuda
        ms = cuda_ms(lambda: fn(*args), 20)
        # The function's own work: each edge of the forest carries its
        # value once, so 16 B per cell (slot and two f32 in, one 4-B word
        # out, or slot and weight in, X and D out) and a few operations
        # per cell (the push's w * (src + G) and one add per edge, the
        # trace's one multiply); the bytes decide.
        nbytes = 16 * W * H
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        entries.append({
            "name": f"tile_{kind}",
            "route": "cuda",
            "source": "soillib_tpu_torch/csrc/tile_accumulate.cu",
            "replaces": ("soillib_tpu/ops/graph_tiled.py:122" if kind ==
                         "local" else "soillib_tpu/ops/graph_tiled.py:135"),
            "launches": dem["launches"][kind],
            "max_abs_err": max(errs),
            "ms": ms,
            "plain_ms": plain_ms[0],
            "bound_ms": bytes_ms,
            "bound_by": "bytes",
            "library_ms": None,
            "bytes_bound_ms": bytes_ms,
            "shape": [W, H],
            "calls_checked_bitwise": len(dem[kind]),
            "tile_depth_max": int(depth.max()) if len(depth) else None,
            "tile_depth_mean": float(depth.mean()) if len(depth) else None,
            "jacobi_tiles": jacobi,
            "tiles": int(rounds.numel()),
            "bytes_per_cell": 16,
        })
        log(f"  tile_{kind}: {len(dem[kind])} calls bitwise equal to plain "
            f"(max abs err {max(errs):.3e}); {ms:.4f} ms/launch, plain "
            f"{plain_ms[0]:.1f} ms, byte bound {bytes_ms:.4f} ms; tile "
            f"depth max {entries[-1]['tile_depth_max']} mean "
            f"{entries[-1]['tile_depth_mean']}; {jacobi} of "
            f"{rounds.numel()} tiles took the Jacobi branch")
    gt.tile_launches.update(saved)
    return entries


class SegmentTimer:
    """While active, each call of the wrapped module functions is timed on
    the host clock between two synchronises and added to its label's
    total (the calls of `accumulate_tiled` do not nest)."""

    def __init__(self, targets):
        self.targets = targets   # (module, name, label)
        self.ms = {label: 0.0 for _, _, label in targets}
        self.calls = dict.fromkeys(self.ms, 0)

    def __enter__(self):
        self.real = [getattr(m, n) for m, n, _ in self.targets]
        for (m, n, label), real in zip(self.targets, self.real):
            def wrapped(*a, _real=real, _label=label, **kw):
                out, ms = timed(lambda: _real(*a, **kw))
                self.ms[_label] += ms
                self.calls[_label] += 1
                return out
            setattr(m, n, wrapped)
        return self

    def __exit__(self, *exc):
        for (m, n, _), real in zip(self.targets, self.real):
            setattr(m, n, real)


def accumulate_segments():
    """The helpers of the tiled accumulation that `SegmentTimer` times: the
    tile kernels; phase 3's boundary set, closed-form ranks and operator
    doubling (whose rounds each read a flag on the host); the slot-graph
    glue."""
    from soillib_tpu_torch.ops import graph, graph_tiled as gt

    return [(graph, "graph_to_slots", "graph_to_slots"),
            (gt, "_local_slot", "_local_slot"),
            (gt, "_pull", "_pull (receivers)"),
            (gt, "local_fp_cuda", "tile push (phases 1, 4)"),
            (gt, "trace_cuda", "tile trace (phase 2)"),
            (gt, "_boundary_index_tensor", "boundary set (cached per shape)"),
            (gt, "_boundary_rank", "_boundary_rank"),
            (graph, "operator_doubling", "operator_doubling")]


def accumulate_breakdown(dem, edge=1):
    """Where one accumulate of the DEM path goes (4096^2, D8, unit rain):
    the host-clock time of each helper (`accumulate_segments`) between
    synchronises, in the path's own first call (cold) and in a later one
    (warm), the rest of the call (the inline gathers, index_add, scatter
    and sums) as the remainder; then the device time by kernel from
    torch.profiler over one more call, and the device's idle share of
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.ops import graph_tiled as gt

    flow, rain = dem["flow"], dem["rain"]
    saved = dict(gt.tile_launches)
    cold = dict(dem["accumulate_cold_segments_ms"])
    cold["rest (gathers, index_add, scatter, sums)"] = \
        dem["ops_ms"]["accumulate"] - sum(cold.values())
    soil.accumulate(flow, rain, soil.d8)   # warm
    with SegmentTimer(accumulate_segments()) as seg:
        _, total = timed(lambda: soil.accumulate(flow, rain, soil.d8))
    parts = dict(seg.ms)
    parts["rest (gathers, index_add, scatter, sums)"] = \
        total - sum(seg.ms.values())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: soil.accumulate(flow, rain, soil.d8))
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + \
                float(e.self_device_time_total) / 1e3
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    gt.tile_launches.update(saved)
    out = {"cold_accumulate_ms": dem["ops_ms"]["accumulate"],
           "cold_segments_ms": cold,
           "accumulate_ms": total, "segments_ms": parts,
           "segment_calls": seg.calls, "profiled_wall_ms": wall,
           "device_busy_ms": busy,
           "idle_share": (idle_share(busy, wall, "profiled accumulate")
                          if wall else None),
           "top_device_kernels_ms": top}
    log("  accumulate 4096^2 breakdown: " + json.dumps(out))
    if busy <= 0.0:
        log("  profiler recorded no device time: device split not "
            "measured")
    return out


def phase_gradients(n=256, iters=32, n_acc=1024):
    """Reverse mode through the kernels on the card: the gradient of one
    coupled step (sum of discharge^2 + height^2 w.r.t. the initial
    terrain, n^2, `iters` rounds; the cohort solves through DiffableCohort)
    and of one accumulate_decay (w.r.t. the value and a per-cell decay at
    n_acc^2; through DiffableTiledAccumulate), each against the plain path
    on the card (the plain rounds; pointer doubling), rtol 1e-5 with an
    absolute floor of 1e-5 of the gradient's scale. Returns the max
    errors."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.models.simulation import erode_step
    from soillib_tpu_torch.ops import cohort, graph_tiled as gt

    p = soil.ErosionParams()
    p.transportIterations = iters
    h0 = terrain(n, 23)

    def step_grad():
        h = h0.clone().requires_grad_(True)
        st = soil.ErosionState.zeros((n, n), height=h)
        out = erode_step(st, (0.1, 0.1, 4.0), p)
        loss = (out.discharge ** 2).sum() + (out.height ** 2).sum()
        return torch.autograd.grad(loss, h)[0]

    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    g_k = step_grad()
    if not nonzero(cohort.cohort_round_launches):
        raise AssertionError("gradient step: no cohort kernel launch")
    run = cohort.run_cohort

    def plain(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        return cohort.cohort_advance_reference(st0, aux, rules, iters, Llen,
                                               closure=closure, tol=tol)[1]

    cohort.run_cohort = plain
    try:
        g_p = step_grad()
    finally:
        cohort.run_cohort = run
    errs = {"coupled step": check_close(
        "coupled-step gradient", g_k, g_p, 1e-5,
        1e-5 * float(g_p.abs().max()))}

    flow = soil.steepest(terrain(n_acc, 29) * 400.0, soil.d8)
    rng = torch.Generator(device="cuda").manual_seed(31)
    v0 = torch.rand((n_acc, n_acc), device="cuda", generator=rng) + 0.5
    d0 = torch.rand((n_acc, n_acc), device="cuda", generator=rng) * 0.2 + 0.8
    ct = torch.randn((n_acc, n_acc), device="cuda", generator=rng)

    def acc_grad(method):
        v = v0.clone().requires_grad_(True)
        d = d0.clone().requires_grad_(True)
        a = soil.accumulate_decay(flow, v, d, soil.d8, method=method)
        return torch.autograd.grad((a * ct).sum(), (v, d))

    n0 = gt.tile_launches["local"]
    got = acc_grad(None)
    if gt.tile_launches["local"] == n0:
        raise AssertionError("gradient accumulate: no tile kernel launch")
    want = acc_grad("doubling")
    for name, x, y in zip(("value", "decay"), got, want):
        errs[f"accumulate_decay d/d{name}"] = check_close(
            f"accumulate_decay gradient w.r.t. {name}", x, y, 1e-5,
            1e-5 * float(y.abs().max()))
    log("  gradient max abs err vs the plain path: " + json.dumps(errs))
    return errs


def torch_arange_grid(t):
    import torch

    W, H = t.shape
    return torch.arange(W * H, dtype=torch.int32,
                        device=t.device).reshape(W, H)


def accumulate_checks(dem, edge=1):
    """Whole accumulations of the DEM path (tile kernels) against the plain
    tiled solver and pointer doubling on the card, rtol 1e-5 / atol 1e-5
    (phase 3's index_add uses atomics)."""
    from soillib_tpu_torch.ops import graph, graph_tiled as gt

    saved = dict(gt.tile_launches)
    g, rain = dem["flow"], dem["rain"]
    slot = graph.graph_to_slots(g, edge)
    errs = {}
    for name, decay in (("accumulate", None), ("accumulate_decay", 0.9999)):
        got = dem["area"] if decay is None else dem["decayed"]
        w = graph._edge_weights(g, decay, edge)
        plain = gt.accumulate_tiled(slot, rain, w, edge, tile_solver="plain")
        errs[f"{name} vs plain tiled"] = check_close(
            f"{name} vs plain tiled", got, plain, 1e-5, 1e-5)
        del plain
        dbl = graph._accumulate_doubling(g, rain, w)
        errs[f"{name} vs doubling"] = check_close(
            f"{name} vs doubling", got, dbl, 1e-5, 1e-5)
        del dbl
    gt.tile_launches.update(saved)
    log("  " + "; ".join(f"{k} max abs err {v:.3e}" for k, v in errs.items()))
    return errs


def sweep_usage():
    """(registers, spill stores, spill loads) that ptxas reported for the
    sweep kernel, from the build log; None if the log does not name it."""
    import re

    from soillib_tpu_torch import _native

    lines = _native.build_log("transport_sweep").splitlines()
    for i, line in enumerate(lines):
        if "transport_rounds_kernel" in line and "Compiling entry" in line:
            regs = spill = None
            for used in lines[i + 1:i + 4]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", used)
                spill = spill or (m and (int(m[1]), int(m[2])))
                m = re.search(r"Used (\d+) registers", used)
                regs = regs or (m and int(m[1]))
            if regs:
                return regs, *(spill or (None, None))
    return None


def sweep_design_bytes(geo, C):
    """Device-memory bytes per owned cell and round of the sweep kernel's
    own design at an interior block: the window's vx, vy and C channels
    of E, att and G read once per launch, the owned G written once."""
    from soillib_tpu_torch.ops import sweep

    tx, ty = sweep.SWEEP_TILE
    window = (tx + 2 * geo.ring) * sweep.SWEEP_WINDOW_COLS
    return 4 * (window * (2 + 3 * C) + tx * ty * C) / (tx * ty * geo.rounds)


def sweep_entry(name, calls, launches, rounds):
    """The sweep kernel against the plain rounds on a path's own inputs,
    bitwise (1 and 16 rounds, through the wrapper's split), then timed per
    round at SWEEP_K rounds a launch, and one plain round."""
    import torch

    from soillib_tpu_torch.ops import sweep

    saved = dict(sweep.sweep_launches), dict(sweep.sweep_rounds)
    E, att, vx, vy = calls[0][0][1:5]
    C, W, H = E.shape
    G0 = torch.zeros_like(E)
    errs = []
    for r in (1, 16):
        got = sweep.transport_advance_cuda(G0, E, att, vx, vy, r)
        want = sweep.transport_advance_reference(G0, E, att, vx, vy, r)
        errs.append(bitwise_err(f"{name}, {r} rounds", got, want))
        del got, want
    K = sweep.SWEEP_K
    G = torch.rand_like(E)
    out = torch.empty_like(E)
    ms = cuda_ms(lambda: sweep.transport_rounds_cuda(G, E, att, vx, vy, K,
                                                     out), 20) / K
    ms_1 = cuda_ms(lambda: sweep.transport_rounds_cuda(G, E, att, vx, vy, 1,
                                                       out), 20)
    plain_ms = cuda_ms(lambda: sweep.upwind_push_cf(att * (E + G), vx, vy), 5)
    # Launches made to compare and time the kernel do not count.
    sweep.sweep_launches.update(saved[0])
    sweep.sweep_rounds.update(saved[1])
    geo = sweep.sweep_geometry(C, W, H, K)
    usage = sweep_usage()
    log(f"  {name} {C}x{W}x{H}: 1 and 16 rounds bitwise equal to the plain "
        f"rounds; {ms:.4f} ms/round at {K} rounds a launch ({ms_1:.4f} at "
        f"1), plain round {plain_ms:.3f} ms; ptxas {usage}")
    return {
        "name": name,
        "route": "cuda",
        "source": "soillib_tpu_torch/csrc/transport_sweep.cu",
        "replaces": "soillib_tpu/ops/sweep.py:92",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": None,
        "bound_by": None,
        "library_ms": None,
        "shape": [C, W, H],
        "bitwise": True,
        "rounds": rounds,
        "rounds_per_launch": K,
        "ms_per_round_at_1_round_a_launch": ms_1,
        "tile": {"block": list(geo.block), "ring": geo.ring,
                 "owned": list(sweep.SWEEP_TILE)},
        "registers": usage and usage[0],
        "spill_bytes": usage and [usage[1], usage[2]],
        "shared_bytes_per_block": geo.smem,
        "bytes_per_cell_round": sweep_design_bytes(geo, C),
    }


def sweep_bound(entry, costs):
    """`set_round_bound` of a sweep entry: the reference round's
    operations per cell, 9 per channel (e + g, att *, four products by
    the donors' weights, three adds) and the weights once per 16-round
    pass ((13 + 2 div) / 16: 2 abs, add, compare and select, two divisions
    weighted by the probe's cost, four compare-selects); E, att and G in,
    G out, vx and vy once per pass: (4C + 2) * 4 bytes."""
    from soillib_tpu_torch import bench

    C = entry["shape"][0]
    set_round_bound(entry, 9 * C + (13 + 2 * costs["div"])
                    / bench.K_ROUNDS_PER_PASS, (4 * C + 2) * 4)


def solve_uniform_check(n=1024, seed=19):
    """A whole solve_uniform (W+H rounds) through the sweep kernel against
    the same solve with the plain rounds on the card, rtol 2e-6 / atol 1e-5
    of the field's scale."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.ops import sweep

    saved = dict(sweep.sweep_launches)
    h = terrain(n, seed) * 400.0
    grad = soil.gradient(soil.fill_depressions(h), (90.0, 90.0))
    velocity = -grad / torch.clamp(
        torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-6)
    rain = torch.ones((n, n), device="cuda")
    evap = torch.full((n, n), 0.001, device="cuda")
    got = soil.solve_uniform(velocity, rain, evap, (90.0, 90.0))
    run = sweep.run_transport
    sweep.run_transport = sweep.transport_sweep_reference
    try:
        want = soil.solve_uniform(velocity, rain, evap, (90.0, 90.0))
    finally:
        sweep.run_transport = run
    sweep.sweep_launches.update(saved)
    err = check_close(f"solve_uniform {n}^2", got, want, 2e-6,
                      1e-5 * float(want.abs().max()))
    log(f"  solve_uniform {n}^2, {2 * n} rounds: kernel vs plain "
        f"{'bitwise equal' if torch.equal(got, want) else 'within rtol'} "
        f"(max abs err {err:.3e})")
    return err


def phase_field_static(n=4096, steps=3, iters=32):
    """ErosionSim at n^2 with transportMethod="field-static": the fluvial
    transport is the sweep kernel at C = 7 (albedo on), the debris one the
    cohort kernel. Returns the sim, the step times, launches and the sweep
    inputs of one more, eager step."""
    import soillib_tpu_torch as soil
    from soillib_tpu_torch.models.simulation import erode_step
    from soillib_tpu_torch.ops import cohort, sweep

    p = soil.ErosionParams()
    p.transportIterations = iters
    p.trackAlbedo = True
    p.transportMethod = "field-static"
    state = soil.ErosionState.zeros((n, n), height=terrain(n, 23))
    sim = soil.ErosionSim((n, n), (0.1, 0.1, 4.0), p, state=state)
    zero_counts(sweep.sweep_launches, sweep.sweep_rounds,
                cohort.cohort_round_launches, cohort.cohort_rounds)
    times = []
    for _ in range(steps):
        _, ms = timed(sim.step)
        times.append(ms)
    launches = nonzero({"sweep": sweep.sweep_launches["round"],
                        **cohort.cohort_round_launches})
    rounds = nonzero({"sweep": sweep.sweep_rounds["round"],
                      **cohort.cohort_rounds})
    # The sweep calls of one more step, eager, for the kernel's checks.
    saved = [dict(c) for c in (sweep.sweep_launches, sweep.sweep_rounds,
                               cohort.cohort_round_launches,
                               cohort.cohort_rounds)]
    with Spy(sweep, "transport_advance_cuda") as sw:
        erode_step(sim.state, sim.scale, sim.param)
    for c, before in zip((sweep.sweep_launches, sweep.sweep_rounds,
                          cohort.cohort_round_launches, cohort.cohort_rounds),
                         saved):
        c.clear()
        c.update(before)
    finite_state(sim.state, f"{n}^2 field-static erode")
    want = {"sweep": steps * len(sweep.sweep_launch_rounds(iters)),
            "debris": steps * len(
                cohort.launch_rounds(iters, cohort.ROUNDS_PER_LAUNCH))}
    if launches != want or rounds != {"sweep": steps * iters,
                                      "debris": steps * iters}:
        raise AssertionError(f"field-static launches {launches} (cohort "
                             f"rounds {rounds}), expected {want}")
    if sw.calls[0][0][1].shape[0] != 7:
        raise AssertionError("field-static sweep is not C = 7")
    log(f"  step ms {[round(t, 1) for t in times]}; steps 2-3 mean "
        f"{np.mean(times[1:]):.1f} ms; launches {launches}; rounds {rounds}")
    return sim, times, launches, rounds, sw.calls


# ---------------------------------------------------------------------------
# The noise, the FP32 probe, the headline bench, the flagship example and
# the quality closure
# ---------------------------------------------------------------------------


def phase_noise(n=4096, crop=1024):
    """noise((n, n), noise_t()) on the card (timed on a second call)
    against the same call on the CPU over a crop^2 corner, atol 1e-6."""
    import torch

    import soillib_tpu_torch as soil

    param = soil.noise_t()
    soil.noise((n, n), param)
    h, ms = timed(lambda: soil.noise((n, n), param))
    if tuple(h.shape) != (n, n) or not bool(torch.isfinite(h).all()):
        raise AssertionError("noise: unexpected shape or non-finite values")
    t0 = time.perf_counter()
    want = soil.noise((crop, crop), param, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got = h[:crop, :crop].cpu()
    err = check_close(f"noise {crop}^2 corner, card vs CPU", got, want, 0.0,
                      1e-6)
    bitwise = torch.equal(got, want)
    log(f"  noise {n}^2 on the card {ms:.1f} ms; {crop}^2 corner vs the "
        f"CPU ({cpu_ms:.0f} ms): max abs err {err:.3e}, "
        f"{'bitwise equal' if bitwise else 'not bitwise'}")
    return {"ms": ms, "cpu_ms": cpu_ms, "max_abs_err": err,
            "bitwise": bitwise}


def phase_probe(short_reps=4):
    """Each op of the FP32 probe kernel against its plain chains on the
    card at a short chain (rtol 1e-5), both timed there; then the timed
    probe (bench `measure_fp32`: rate and cost weights)."""
    import torch

    from soillib_tpu_torch import bench
    from soillib_tpu_torch.ops import fp32_chain as fc

    dev = torch.device("cuda", torch.cuda.current_device())
    saved = dict(fc.fp32_chain_launches)
    n = fc.probe_elements(dev)
    x = torch.from_numpy(np.random.default_rng(29).uniform(
        0.25, 1.0, n).astype(np.float32)).cuda()
    errs = {}
    for op in fc.OPS:
        got = fc.chain_cuda(x, op, short_reps)
        want = fc.chain_plain(x, op, short_reps)
        errs[op] = check_close(f"fp32_chain[{op}], {short_reps} reps", got,
                               want, 1e-5, 0.0)
    ms_short = cuda_ms(lambda: fc.chain_cuda(x, "fma", short_reps), 20)
    plain_ms = cuda_ms(lambda: fc.chain_plain(x, "fma", short_reps), 3)
    fp32 = bench.measure_fp32(dev)
    fc.fp32_chain_launches.update(saved)
    log(f"  {n} elements, {short_reps} reps: max abs err "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; "
        f"fma kernel {ms_short:.4f} ms, plain {plain_ms:.2f} ms")
    log(f"  timed probe ({fp32['reps']} reps): fma launch "
        f"{fp32['fma_launch_s'] * 1e3:.2f} ms, rate "
        f"{fp32['probe'] / 1e12:.2f}e12/s (spec {fp32['spec'] / 1e12:.2f}"
        f"e12/s); cost weights "
        f"{json.dumps({k: round(v, 2) for k, v in fp32['costs'].items()})}")
    return {"errs": errs, "ms_short": ms_short, "plain_ms": plain_ms,
            "short_reps": short_reps, "fp32": fp32}


def probe_entry(probe, launches):
    """The probe kernel's line of the report: its fma launch at the
    bench's reps against the spec-rate bound."""
    from soillib_tpu_torch.ops import fp32_chain as fc

    fp32 = probe["fp32"]
    ops = fc.ops_per_launch(fp32["elements"], fp32["reps"])
    bound_ms = ops / PEAK_F32_PER_S * 1e3
    return {
        "name": "fp32_chain[fma]",
        "route": "cuda",
        "source": "soillib_tpu_torch/csrc/fp32_chain.cu",
        "replaces": "bench.py:98",
        "launches": launches["fma"],
        "max_abs_err": probe["errs"]["fma"],
        "ms": fp32["fma_launch_s"] * 1e3,
        "plain_ms": probe["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "operations",
        "library_ms": None,
        "ops": ops,
        "reps": fp32["reps"],
        "elements": fp32["elements"],
        "plain_reps": probe["short_reps"],
        "ms_at_plain_reps": probe["ms_short"],
        "max_abs_err_by_op": probe["errs"],
        "probe_ops_per_s": fp32["probe"],
        "spec_ops_per_s": fp32["spec"],
        "cost_weights": fp32["costs"],
    }


def phase_bench(n=4096, steps=8):
    """The headline bench's main in this process at n^2, --iters 32 and
    auto; both print their JSON line. Returns the two lines and the
    probe kernel's launches."""
    from soillib_tpu_torch import bench
    from soillib_tpu_torch.ops import cohort
    from soillib_tpu_torch.ops import fp32_chain as fc

    keys = {"metric", "value", "unit", "vs_baseline", "hbm_sol",
            "compute_sol", "bw_bytes_per_s", "bytes_per_cell_step",
            "fp32_ops_per_s", "fp32_ops_per_cell_step", "device"}
    zero_counts(fc.fp32_chain_launches, cohort.cohort_round_launches,
                cohort.cohort_rounds)
    out = {}
    for iters in ("32", "auto"):
        line, ms = timed(lambda: bench.main(
            ["--size", str(n), "--iters", iters, "--steps", str(steps)]))
        if set(line) != keys:
            raise AssertionError(f"bench --iters {iters}: keys {sorted(line)}")
        if not (math.isfinite(line["value"]) and line["value"] > 0):
            raise AssertionError(f"bench --iters {iters}: value "
                                 f"{line['value']}")
        out[iters] = line
        log(f"  bench --iters {iters}: {ms / 1e3:.1f} s in all")
    launches = dict(fc.fp32_chain_launches)
    if min(launches.values()) == 0 or not cohort.cohort_round_launches[
            "fluvial"]:
        raise AssertionError(f"bench launches: probe {launches}, cohort "
                             f"{nonzero(cohort.cohort_round_launches)}")
    if out["32"]["bytes_per_cell_step"] != 1488.0:
        raise AssertionError("bench: bytes per cell-step at 32 rounds is "
                             f"{out['32']['bytes_per_cell_step']}, not 1488")
    log(f"  probe launches {launches}; cohort launches "
        f"{nonzero(cohort.cohort_round_launches)}")
    return out, launches


def phase_example(res=1024, steps=32, report=16):
    """The flagship example's main at res^2; its erosion.zip must read
    back (zip_load) bitwise equal to the final state, with the pixel
    scale."""
    import os
    import tempfile

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.examples import erosion as example

    with tempfile.TemporaryDirectory() as d:
        run, ms = timed(lambda: example.main(
            ["--res", str(res), "--steps", str(steps), "--report",
             str(report), "--out", d]))
        loaded = soil.util.zip_load(os.path.join(d, "erosion.zip"))
    sim = run["sim"]
    finite_state(sim.state, f"example {res}^2")
    pscale = [20.0 / res, 20.0 / res, 4.0]
    for name in ("height", "sediment", "discharge"):
        arr, meta = loaded[name]
        want = getattr(sim.state, name).cpu().numpy()
        if arr.dtype != np.float32 or not np.array_equal(arr, want):
            raise AssertionError(f"example: erosion.zip {name} differs from "
                                 f"the final state")
        if not np.allclose(meta.scale, pscale, rtol=1e-6):
            raise AssertionError(f"example: {name} scale {meta.scale}")
    log(f"  ms/step per report {run['ms_per_step']}; whole run {ms:.0f} "
        f"ms; erosion.zip read back bitwise")
    return run["ms_per_step"]


def quality_params(iters):
    import soillib_tpu_torch as soil

    p = soil.ErosionParams()
    p.transportIterations = iters
    p.trackAlbedo = True
    p.closure = soil.CohortClosure(nodes=4, colors=8)
    return p


def phase_quality_erode_check(n=256, steps=2, iters=32):
    """A quality erode (CohortClosure(nodes=4, colors=8)) through the
    kernel against the same erode with the plain rounds, both on the
    card and both eager `erode_step`s (the plain rounds are patched in):
    fields at rtol 1e-4 / atol 1e-6 of each field's scale."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.models.simulation import _canonicalize, erode_step
    from soillib_tpu_torch.ops import cohort

    def erode(state):
        state = _canonicalize(state, p)
        for _ in range(steps):
            state = erode_step(state, (0.1, 0.1, 4.0), p)
        return state

    p = quality_params(iters)
    h = terrain(n, 31)
    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    got = erode(soil.ErosionState.zeros((n, n), height=h))
    launches = nonzero(cohort.cohort_round_launches)
    check_quality_counts(launches, nonzero(cohort.cohort_rounds), steps,
                         iters, "quality erode")
    run = cohort.run_cohort

    def plain(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        return cohort.cohort_advance_reference(
            cohort.as_stack(st0), cohort.as_stack(aux), rules, int(iters),
            Llen, closure=closure, tol=tol)[1]

    cohort.run_cohort = plain
    try:
        want = erode(soil.ErosionState.zeros((n, n), height=h))
    finally:
        cohort.run_cohort = run
    errs, same = {}, True
    for name in ("height", "sediment", "discharge", "mass", "debris"):
        g, w = getattr(got, name), getattr(want, name)
        errs[name] = check_close(f"quality erode {n}^2 {name}", g, w, 1e-4,
                                 1e-6 * float(w.abs().max()))
        same = same and torch.equal(g, w)
    log(f"  {n}^2, {steps} steps: kernel path vs plain path "
        f"{'bitwise equal' if same else 'within rtol 1e-4'}; max abs err "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; "
        f"launches {launches}")
    return errs


def check_quality_counts(launches, rounds, steps, iters, what):
    """A quality solve's counts: the fluvial NODES=4 kernel runs one round
    per launch and color group (8), the debris solve (default closure)
    ROUNDS_PER_LAUNCH rounds a launch."""
    from soillib_tpu_torch.ops import cohort

    split = len(cohort.launch_rounds(iters, cohort.ROUNDS_PER_LAUNCH))
    want_r = {"fluvial,nodes=4": steps * iters * 8, "debris": steps * iters}
    want_l = {"fluvial,nodes=4": steps * iters * 8, "debris": steps * split}
    if rounds != want_r or launches != want_l:
        raise AssertionError(f"{what}: rounds {rounds} in launches "
                             f"{launches}, expected {want_r} in {want_l}")


class CaptureFirstGroup:
    """While active, keeps a copy of the first color group of the first
    fluvial cohort solve's state (and its aux, rules, Llen); the solve
    itself runs on."""

    def __init__(self, per):
        self.per, self.captured = per, None

    def __enter__(self):
        from soillib_tpu_torch.ops import cohort

        run = self.run = cohort.run_cohort

        def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
            if self.captured is None and rules.kind == "fluvial":
                st = cohort.as_stack(st0)
                self.captured = (st[:self.per].clone(),
                                 cohort.as_stack(aux).clone(), rules, Llen)
            return run(st0, aux, rules, iters, Llen, closure, tol)

        cohort.run_cohort = spy
        return self

    def __exit__(self, *exc):
        from soillib_tpu_torch.ops import cohort

        cohort.run_cohort = self.run


def phase_quality(n=4096, steps=2, iters=32):
    """ErosionSim at n^2 with CohortClosure(nodes=4, colors=8): the
    fluvial solve launches the NODES=4 kernel once per color group and
    round, in chunks of color groups chosen by the memory rule
    (`color_chunk`, once per step); the debris solve keeps the default
    closure. Returns
    the sim, the step times, the launches, the chunk and the captured
    inputs of one color group."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.models import erosion
    from soillib_tpu_torch.ops import cohort

    p = quality_params(iters)
    state = soil.ErosionState.zeros((n, n), height=terrain(n, 37))
    sim = soil.ErosionSim((n, n), (0.1, 0.1, 4.0), p, state=state)
    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    torch.cuda.reset_peak_memory_stats()
    times = []
    with Spy(erosion, "color_chunk") as chunk, \
            CaptureFirstGroup(4 * (cohort.NSTATE + 7)) as cap:
        for _ in range(steps):
            _, ms = timed(sim.step)
            times.append(ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = nonzero(cohort.cohort_round_launches)
    finite_state(sim.state, f"{n}^2 quality erode")
    check_quality_counts(launches, nonzero(cohort.cohort_rounds), steps,
                         iters, "quality")
    chunks = [out for _, out in chunk.calls]
    log(f"  step ms {[round(t, 1) for t in times]} (the first with the "
        f"warm-up and the capture); launches {launches}; color groups per "
        f"chunk, at the warm-up and at the capture: {chunks} of 8 (68 "
        f"channels each); peak memory {peak_gb:.1f} GB")
    return sim, times, launches, chunks, cap.captured


# ---------------------------------------------------------------------------
# The multiscale cascade, the trajectory golden and the DEM and TIFF
# examples
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
# Level 0 of the cascade runs the reference's full 2048 steps; a smaller
# number here is a cut, printed and recorded with the phase's results.
CASCADE_LEVEL0_STEPS = 2048


def sample_solves():
    """While active, keeps a copy of the cohort solve inputs (st, aux,
    rules, Llen) of each rule set at the first step of each level of the
    cascade: the compiled step's eager warm-up, which runs the level's
    first step from the level's own input state (a replayed step calls no
    Python), by the grid shape they come at: (W, H, kind, 0) -> inputs;
    and each level's final state, by its shape. `more_solves` adds the
    solves of one more eager step from each final state."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.ops import cohort

    kept, finals = {}, {}
    run, cascade = cohort.run_cohort, soil.run_cascade

    def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        st, aux = cohort.as_stack(st0), cohort.as_stack(aux)
        if not torch.cuda.is_current_stream_capturing():
            kept.setdefault((*st.shape[1:], rules.kind, 0),
                            (st.clone(), aux.clone(), rules, Llen))
        return run(st, aux, rules, iters, Llen, closure, tol)

    def level(state, levels, *args, **kw):
        out = cascade(state, levels, *args, **kw)
        finals[tuple(out.layers.shape[-2:])] = out
        return out

    class Sampler:
        def __enter__(self):
            cohort.run_cohort, soil.run_cascade = spy, level
            return kept, finals

        def __exit__(self, *exc):
            cohort.run_cohort, soil.run_cascade = run, cascade

    return Sampler()


def more_solves(kept, finals, steps, param):
    """The cohort solve inputs of one eager `erode_step` from each level's
    final state, kept as (W, H, kind, steps of the level)."""
    import soillib_tpu_torch as soil
    from soillib_tpu_torch.examples import multiscale
    from soillib_tpu_torch.models.simulation import erode_step
    from soillib_tpu_torch.ops import cohort

    run = cohort.run_cohort
    for res, state in finals.items():
        def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0,
                res=res):
            st, aux = cohort.as_stack(st0), cohort.as_stack(aux)
            kept[(*res, rules.kind, steps[res])] = (st.clone(), aux.clone(),
                                                   rules, Llen)
            return run(st, aux, rules, iters, Llen, closure, tol)

        cohort.run_cohort = spy
        try:
            erode_step(state, soil.level_scale(multiscale.WORLD,
                                               multiscale.ZSCALE, res), param)
        finally:
            cohort.run_cohort = run


def phase_cascade(level0_steps=CASCADE_LEVEL0_STEPS):
    """The multiscale example's main at the reference's levels [(128^2,
    2048), (256^2, 4), (1000^2, 4)] on the card (64 cohort rounds a solve,
    the flagship example's parameters): per-level ms per step and the
    cohort launches and rounds of the run (counted from zero), a finite
    final state read back from multiscale.zip bitwise; then the cohort
    solves of the first step of every level (the compiled step's eager
    warm-up) and of one eager step from every level's final state, on the
    cascade's own inputs, kernel against the plain rounds, bitwise at the
    solve's full depth, and the kernel's time per round on each level's
    last inputs."""
    import tempfile

    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.examples import erosion, multiscale
    from soillib_tpu_torch.ops import cohort

    levels = [(r, level0_steps if i == 0 else s)
              for i, (r, s) in enumerate(multiscale.DEFAULT_LEVELS)]
    cut = (None if levels == multiscale.DEFAULT_LEVELS else
           f"level 0 cut from {multiscale.DEFAULT_LEVELS[0][1]} to "
           f"{level0_steps} steps")
    argv = [] if cut is None else [
        "--levels", ",".join(f"{r[0]}:{n}" for r, n in levels)]
    param = erosion.make_param()
    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    with tempfile.TemporaryDirectory() as d, sample_solves() as (kept,
                                                                 finals):
        run, ms = timed(lambda: multiscale.main(argv + ["--out", d]))
        loaded = soil.util.zip_load(os.path.join(d, "multiscale.zip"))
    launches = nonzero(cohort.cohort_round_launches)
    rounds = nonzero(cohort.cohort_rounds)
    saved = dict(cohort.cohort_round_launches), dict(cohort.cohort_rounds)
    more_solves(kept, finals, {tuple(r): n for r, n in levels}, param)
    del finals
    state = run["state"]
    finite_state(state, "cascade")
    if tuple(state.layers.shape) != (2, 1000, 1000):
        raise AssertionError(f"cascade: final layers {state.layers.shape}")
    for name in ("height", "sediment", "discharge"):
        if not np.array_equal(loaded[name][0],
                              getattr(state, name).cpu().numpy()):
            raise AssertionError(f"cascade: multiscale.zip {name} differs "
                                 f"from the final state")
    steps = sum(n for _, n in levels)
    it = param.transportIterations
    want_r = {"fluvial": steps * it, "debris": steps * it}
    want_l = {k: steps * len(cohort.launch_rounds(
        it, cohort.ROUNDS_PER_LAUNCH)) for k in want_r}
    if rounds != want_r or launches != want_l:
        raise AssertionError(f"cascade: rounds {rounds} in launches "
                             f"{launches}, expected {want_r} in {want_l}")
    want_k = {(*r, kind, i) for r, n in levels for i in (0, n)
              for kind in ("fluvial", "debris")}
    if set(kept) != want_k:
        raise AssertionError(f"cascade: sampled solves {sorted(kept)}, "
                             f"expected {sorted(want_k)}")

    # The sampled solves: kernel against plain, bitwise at the solve's
    # full depth; then the kernel's time per round on each level's
    # last inputs.
    errs, kernel_ms = {}, {}
    K = cohort.ROUNDS_PER_LAUNCH
    for (W, H, kind, i), (st, aux, rules, Llen) in sorted(kept.items()):
        st_k, g_k = cohort.cohort_advance_cuda(st, aux, rules, it, Llen)
        st_p, g_p = cohort.cohort_advance_reference(st, aux, rules, it, Llen)
        what = f"cascade {W}x{H} step {i} {kind} solve, {it} rounds"
        errs[f"{kind} {W}^2 step {i}"] = max(
            bitwise_err(f"{what}, state", st_k, st_p),
            bitwise_err(f"{what}, deposits", g_k, g_p))
        del st_k, g_k, st_p, g_p
    for r, n in levels:
        for kind in ("fluvial", "debris"):
            st, aux, rules, Llen = kept[(*r, kind, n)]
            G = torch.zeros((st.shape[0] - cohort.NSTATE, *r),
                            device="cuda")
            out = torch.empty_like(st)
            kernel_ms[f"{kind} {r[0]}^2"] = cuda_ms(
                lambda: cohort.cohort_rounds_cuda(st, aux, G, rules, Llen,
                                                  K, out=out), 50) / K
    del kept
    # Where a step's time goes at the finest and the coarsest level, read
    # through the marks after a warm step (level 0's on a fresh 128^2
    # state).
    scale = soil.level_scale(multiscale.WORLD, multiscale.ZSCALE,
                             (1000, 1000))
    sim = soil.ErosionSim((1000, 1000), scale, param, state=state)
    sim.step()
    breakdown = {"1000^2": phase_breakdown(sim)}
    del sim
    sim = soil.ErosionSim((128, 128), soil.level_scale(
        multiscale.WORLD, multiscale.ZSCALE, (128, 128)), param,
        state=soil.ErosionState.zeros((128, 128), height=soil.noise(
            (128, 128), soil.noise_t(seed=3.0, ext=(128, 128)))))
    sim.step(2)
    breakdown["128^2"] = phase_breakdown(sim)
    cohort.cohort_round_launches.update(saved[0])
    cohort.cohort_rounds.update(saved[1])
    out = {"levels": [[list(r), n] for r, n in levels], "cut": cut,
           "breakdown": breakdown,
           "ms_per_step": run["ms_per_step"], "seconds": run["seconds"],
           "main_ms": ms, "launches": launches, "rounds": rounds,
           "solve_max_abs_err": errs,
           "kernel_ms_per_round": kernel_ms}
    log(f"  cascade {'(' + cut + ') ' if cut else ''}ms/step per level "
        f"{[round(m, 3) for m in run['ms_per_step']]}, total "
        f"{run['seconds']:.2f} s; cohort launches {launches}, rounds "
        f"{rounds}; the solves of the first step of every level and of one "
        f"step past its last "
        f"({len(errs)}) bitwise equal to plain; kernel ms per round "
        f"{json.dumps({k: round(v, 4) for k, v in kernel_ms.items()})}"
        f"; idle % inside the step's graph "
        f"{json.dumps({k: v and v['step_idle_pct'] for k, v in breakdown.items()})}")
    return out


def phase_golden(n=128, steps=30, npz="golden_traj128.npz"):
    """tests/test_golden.py's trajectory (n^2, `steps` coupled steps, 16
    transport rounds, seed-5 noise x 0.5 + 2) on the card through the
    cohort kernel, against tests/data/<npz>: field statistics at rtol
    5e-3, the 16 x 16 block-mean fingerprint at rtol 1e-2 / atol 1e-3. A
    miss raises."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.ops import cohort

    g = np.load(os.path.join(REPO, "tests", "data", npz))
    p = soil.ErosionParams()
    p.transportIterations = 16
    h = soil.noise((n, n), soil.noise_t(seed=5.0, ext=(float(n),) * 2)) \
        * 0.5 + 2.0
    state = soil.ErosionState.zeros((n, n), height=h)
    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    state, ms = timed(lambda: soil.erode(state, (0.1, 0.1, 4.0), p,
                                         steps=steps))
    launches = nonzero(cohort.cohort_round_launches)
    if sorted(launches) != ["debris", "fluvial"]:
        raise AssertionError(f"golden: cohort launches {launches}")
    finite_state(state, "golden trajectory")
    worst = {}

    def within(name, got, want, rtol, atol):
        err = np.abs(got - want)
        ratio = float((err / (atol + rtol * np.abs(want))).max())
        worst[name] = ratio
        if ratio > 1.0:
            raise AssertionError(
                f"golden {n}x{steps}: {name} outside rtol {rtol} / atol "
                f"{atol} (worst error {ratio:.3f} of the allowance)")

    k = n // 16
    for name in ("height", "discharge", "sediment"):
        arr = getattr(state, name).cpu().numpy()
        stats = np.array([arr.mean(), arr.std(), np.abs(arr).max()])
        within(f"{name} stats", stats, g[f"{name}_stats"], 5e-3, 0.0)
        if name != "sediment":
            blocks = arr.reshape(n // k, k, n // k, k).mean(axis=(1, 3))
            within(f"{name} fingerprint", blocks, g[f"{name}_blocks"],
                   1e-2, 1e-3)
    log(f"  golden {n}x{steps} on the card ({ms:.0f} ms, cohort launches "
        f"{launches}): within the golden tolerances; worst error as a "
        f"share of the allowance {json.dumps({k: round(v, 4) for k, v in worst.items()})}")
    return {"ms": ms, "launches": launches, "worst_share": worst}


def ragged_tile_checks(seed=37):
    """The tile kernels at 1000^2 and 1000 x 744 (7 full tiles and one of
    104 cells, 5 and 104 along y at 744), D8, on the steepest graph of a
    seeded terrain with a per-cell payload and decay: push and trace
    bitwise equal to the plain fixed points."""
    import torch

    from soillib_tpu_torch.ops import graph, graph_tiled as gt

    saved = dict(gt.tile_launches)
    errs = {}
    h = terrain(1000, seed) * 400.0
    rng = torch.Generator(device="cuda").manual_seed(seed)
    for W, H in ((1000, 1000), (1000, 744)):
        slot = graph.graph_to_slots(
            graph.steepest(h[:W, :H].contiguous(), 1), 1).contiguous()
        src = torch.rand((W, H), device="cuda", generator=rng) + 0.5
        w = torch.rand((W, H), device="cuda", generator=rng) * 0.2 + 0.8
        lslot, cross = gt._local_slot(W, H, slot, 1)
        recv = gt._pull(torch_arange_grid(slot), slot, 1, 0)
        iters = gt.TILE ** 2
        G = gt.local_fp_cuda(lslot.contiguous(), src, w, 1, iters)[0]
        X, D = gt.trace_cuda(slot, w, 1, iters)[:2]
        Xp, Dp = gt.trace_plain(slot, cross, recv, w, 1, iters)
        errs[f"{W}x{H}"] = max(
            bitwise_err(f"tile push {W}x{H}", G,
                        gt.local_fp_plain(lslot, src, w, 1, iters)),
            bitwise_err(f"tile trace X {W}x{H}", X, Xp),
            bitwise_err(f"tile trace D {W}x{H}", D, Dp))
    gt.tile_launches.update(saved)
    log(f"  tile kernels at 1000x1000 and 1000x744 bitwise equal to plain "
        f"(push and trace)")
    return errs


def write_tiles(d, n=1024, seed=41):
    """Two adjacent n^2 GeoTIFF tiles (pixel scale 1, x offsets 0 and n)
    of seeded terrain, as the tests write their tiles for tiff_merge."""
    import soillib_tpu_torch as soil

    for i in range(2):
        g = soil.geotiff(terrain(n, seed + i).cpu().numpy() * 400.0)
        g.meta.scale = [1.0, 1.0, 1.0]
        g.meta.coords = [0, 0, 0, float(n * i), 0.0, 0.0]
        g.write(os.path.join(d, f"tile{i}.tiff"))


def phase_dem_examples():
    """The DEM examples' mains on the card with --out "": dem_process at
    1024^2, dem_condition at 512^2 and dem_multiflow at 1024^2 (K = 512,
    batch 64), each with its tile and sweep launches counted from zero.
    Every tile and sweep call of dem_process, and every tile call of one
    dem_multiflow batch (the run's first, once more), is held bitwise
    against its plain version on the call's own inputs. Then the tile
    kernels at ragged sizes; then tiff_merge, tiff_mesh and tiff_view on
    two 1024^2 GeoTIFF tiles: the merged raster and the PLY have the
    expected sizes."""
    import tempfile

    import torch

    from soillib_tpu_torch.examples import (
        dem_condition,
        dem_multiflow,
        dem_process,
        tiff_merge,
        tiff_mesh,
        tiff_view,
    )
    from soillib_tpu_torch.ops import graph_tiled as gt
    from soillib_tpu_torch.ops import sweep

    out = {}

    def counted(name, fn, want):
        zero_counts(gt.tile_launches, sweep.sweep_launches,
                    sweep.sweep_rounds)
        run, ms = timed(fn)
        got = {"local": gt.tile_launches["local"],
               "trace": gt.tile_launches["trace"],
               "sweep": sweep.sweep_launches["round"],
               "sweep_rounds": sweep.sweep_rounds["round"]}
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        out[name] = {"launches": got, "main_ms": ms}
        return run

    def tile_spies():
        return Spy(gt, "local_fp_cuda"), Spy(gt, "trace_cuda")

    def check_calls(name, loc, tr, sw=None):
        errs = (tile_call_errs(name, "local", loc.calls)[0]
                + tile_call_errs(name, "trace", tr.calls)[0]
                + (sweep_call_errs(name, sw.calls) if sw else []))
        out[name]["calls_checked_bitwise"] = {
            "local": len(loc.calls), "trace": len(tr.calls),
            "sweep": len(sw.calls) if sw else 0, "max_abs_err": max(errs)}

    # dem_process warms its flow pipeline once (2 + 2 push, 1 + 1 trace
    # launches) and its sweep with a one-round solve.
    n = 1024
    loc, tr = tile_spies()
    with loc, tr, Spy(sweep, "transport_advance_cuda") as sw:
        run = counted("dem_process", lambda: dem_process.main(
            ["--res", str(n), "--out", ""]),
            {"local": 8, "trace": 4,
             "sweep": 1 + len(sweep.sweep_launch_rounds(2 * n)),
             "sweep_rounds": 1 + 2 * n})
    check_calls("dem_process", loc, tr, sw)
    del loc, tr, sw
    for k in ("height", "area", "decayed", "gradient", "discharge"):
        if not bool(torch.isfinite(run[k]).all()):
            raise AssertionError(f"dem_process: non-finite {k}")
    total = float(run["area"][run["flow"] < 0].double().sum())
    if abs(total - n * n) > 1e-4 * n * n:
        raise AssertionError(f"dem_process: roots receive {total} of "
                             f"{n * n} cells' rain")
    out["dem_process"]["ops_ms"] = run["ms"]
    run = counted("dem_condition", lambda: dem_condition.main(
        ["--res", "512", "--out", ""]),
        {"local": 2, "trace": 1, "sweep": 0, "sweep_rounds": 0})
    if run["pits_after"] != 0:
        raise AssertionError(f"dem_condition: {run['pits_after']} interior "
                             f"pits left")
    out["dem_condition"].update(ms=run["ms"], pits=[run["pits_before"],
                                                    run["pits_after"]])
    K, T, batch = 512, 10.0, 64
    run = counted("dem_multiflow", lambda: dem_multiflow.main(
        ["--res", str(n), "--K", str(K), "--T", str(T), "--batch",
         str(batch), "--out", ""]),
        {"local": 2 * K, "trace": K, "sweep": 0, "sweep_rounds": 0})
    mf = run["multiflow"]
    if not bool(torch.isfinite(mf).all()) or float(mf.min()) < 1.0:
        raise AssertionError("dem_multiflow: a contributing area below one "
                             "cell or non-finite")
    out["dem_multiflow"]["ms_per_member"] = run["ms_per_member"]
    # The run's first batch once more (members 0-63 draw from seeds 0-63,
    # so the kernels see the run's own inputs), its counts put back.
    saved = dict(gt.tile_launches)
    loc, tr = tile_spies()
    with loc, tr:
        dem_multiflow.multiflow(run["height"], batch, T, batch)
    gt.tile_launches.update(saved)
    check_calls("dem_multiflow", loc, tr)
    del loc, tr
    log(f"  {json.dumps(out)}")
    out["ragged_tiles"] = ragged_tile_checks()

    with tempfile.TemporaryDirectory() as d:
        tiles = os.path.join(d, "tiles")
        os.makedirs(tiles)
        write_tiles(tiles)
        merged, ms_merge = timed(lambda: tiff_merge.main(
            [tiles, "--pscale", "1.0", "--out", ""]))
        m = merged["merged"]
        if tuple(m.shape) != (2048, 1024) or bool(torch.isnan(m).any()):
            raise AssertionError(f"tiff_merge: raster {tuple(m.shape)} with "
                                 f"{int(torch.isnan(m).sum())} NaN cells")
        ply = os.path.join(d, "tile0.ply")
        mesh, ms_mesh = timed(lambda: tiff_mesh.main(
            [os.path.join(tiles, "tile0.tiff"), ply]))
        V, F = len(mesh["mesh"].vertices), len(mesh["mesh"].faces)
        header = len(mesh["mesh"]._header(ascii=False))
        size = os.path.getsize(ply)
        if (V, F) != (1024 * 1024, 2 * 1023 * 1023) or \
                size != header + 12 * V + 13 * F:
            raise AssertionError(f"tiff_mesh: {V} vertices, {F} faces, "
                                 f"{size} bytes")
        view, ms_view = timed(lambda: tiff_view.main([tiles, "--out", ""]))
        if [a.shape for _, a in view["images"]] != [(1024, 1024)] * 2:
            raise AssertionError("tiff_view: unexpected images")
    out["tiff"] = {"merge_ms": ms_merge, "mesh_ms": ms_mesh,
                   "view_ms": ms_view, "merged_shape": [2048, 1024],
                   "ply_bytes": size}
    log(f"  tiff_merge 2 x 1024^2 -> 2048x1024 in {ms_merge:.0f} ms; "
        f"tiff_mesh {V} vertices, {F} faces, {size} B in {ms_mesh:.0f} ms; "
        f"tiff_view {ms_view:.0f} ms")
    return out


# ---------------------------------------------------------------------------
# The closure variants of the cohort kernel
# ---------------------------------------------------------------------------

def variant_solves(cl, changed=False):
    """{kind: closure} of the cohort solves of an erode step with closure
    `cl`: the fluvial solve with `cl`, the debris solve with `cl` less its
    nodes and colors (`_debris_closure`). With `changed`, only those whose
    kernel build `cl` changes (the node rules reach the fluvial solve
    only)."""
    import dataclasses

    from soillib_tpu_torch.ops import cohort

    out = {"fluvial": cl,
           "debris": dataclasses.replace(cl, nodes=1, colors=1)}
    return {kind: c for kind, c in out.items()
            if not changed or cohort.kernel_variant(c, c.nodes).defines()}


def variant_grad(cl, n=128, iters=4):
    """A check that the closure reaches the backward: `iters` fluvial
    rounds through run_cohort on the card (DiffableCohort: the variant's
    kernel forward, launches counted; the plain rounds backward) on
    tests/test_grad_closures.py's band problem at n^2 (soillib_tpu_torch
    .testing `band_problem`), against the plain rounds' own autograd on
    the card. The forward deposits are held to the kernel's gates
    (bitwise for one node, rtol 2e-5 / atol 1e-5 for N nodes); the
    gradient of sum(G^2) w.r.t. the velocity field at rtol 1e-5 with an
    absolute floor of 1e-5 of its scale (phase 14's bar): both sides run
    the same plain backward, so this holds the wiring, not the kernel.
    Returns the max abs errors of the deposits and of the gradient."""
    import torch

    from soillib_tpu_torch.models.erosion import make_fluvial_rules
    from soillib_tpu_torch.models.params import ErosionParams
    from soillib_tpu_torch.ops import cohort
    from soillib_tpu_torch.testing import band_problem

    rules = make_fluvial_rules(ErosionParams(), 0.1)

    def grad(solve):
        v = (0.4 * torch.ones((n, n), device="cuda")).requires_grad_(True)
        st, aux = band_problem(cl, v)
        G = solve(st, aux)
        return G.detach(), torch.autograd.grad((G * G).sum(), v)[0]

    key = cohort.launch_key("fluvial", cl.nodes,
                            cohort.kernel_variant(cl, cl.nodes).tag)
    n0 = cohort.cohort_round_launches.get(key, 0)
    G, got = grad(lambda st, aux: cohort.run_cohort(st, aux, rules, iters,
                                                    0.1, cl))
    if cohort.cohort_round_launches.get(key, 0) == n0:
        raise AssertionError(f"{key} gradient: no kernel launch")
    G_p, want = grad(lambda st, aux: cohort.cohort_advance_reference(
        st, aux, rules, iters, 0.1, closure=cl)[1])
    if float(want.abs().max()) <= 0.0:
        raise AssertionError(f"{key} gradient: zero on the plain path")
    if cl.nodes == 1:
        g_err = bitwise_err(f"{key} forward deposits", G, G_p)
    else:
        g_err = check_close(f"{key} forward deposits", G, G_p, 2e-5, 1e-5)
    return g_err, check_close(f"{key} gradient", got, want, 1e-5,
                              1e-5 * float(want.abs().max()))


def variant_erode(cl, n=4096, steps=2, iters=32):
    """ErosionSim at n^2 with closure `cl`, `steps` steps of `iters` rounds,
    albedo on; checks the state finite and every solve's rounds under its
    variant's launch key. Returns the step times, the launches and the
    first step's solve inputs by rule kind."""
    import soillib_tpu_torch as soil
    from soillib_tpu_torch.ops import cohort

    p = soil.ErosionParams()
    p.transportIterations = iters
    p.trackAlbedo = True
    p.closure = cl
    state = soil.ErosionState.zeros((n, n), height=terrain(n, 7))
    sim = soil.ErosionSim((n, n), (0.1, 0.1, 4.0), p, state=state)
    captured = {}
    run = cohort.run_cohort

    def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        if rules.kind not in captured:
            captured[rules.kind] = (cohort.as_stack(st0).clone(),
                                    cohort.as_stack(aux).clone(), rules,
                                    Llen)
        return run(st0, aux, rules, iters, Llen, closure, tol)

    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    times = []
    cohort.run_cohort = spy
    try:
        for _ in range(steps):
            times.append(timed(sim.step)[1])
    finally:
        cohort.run_cohort = run
    launches = nonzero(cohort.cohort_round_launches)
    rounds = nonzero(cohort.cohort_rounds)
    finite_state(sim.state, f"{n}^2 erode with {cl}")
    want = {cohort.launch_key(kind, c.nodes,
                              cohort.kernel_variant(c, c.nodes).tag):
            steps * iters for kind, c in variant_solves(cl).items()}
    if rounds != want:
        raise AssertionError(f"{cl}: rounds {rounds} in launches "
                             f"{launches}, expected {want}")
    return times, launches, captured


def phase_variants():
    """Every closure variant (soillib_tpu_torch.testing VARIANTS): its
    kernel libraries built together (one nvcc each), its kernels held
    against the plain round on seeded 512^2 inputs (fluvial and debris
    where the closure reaches them, `round_checks`), the closure carried
    through the backward at 128^2 (`variant_grad`), then two 4096^2
    coupled steps with the closure (32 rounds, albedo on), and each of its
    kernels checked and timed on the first step's inputs (`kernel_entry`).
    Returns the kernel entries (bounds set later by `cohort_bound`)."""
    import torch

    from soillib_tpu_torch import _native
    from soillib_tpu_torch.ops import cohort
    from soillib_tpu_torch.testing import CLOSURES, VARIANTS, split_nodes

    solves = {name: variant_solves(CLOSURES[name], changed=True)
              for name in VARIANTS}
    defines = sorted({cohort.kernel_variant(c, c.nodes).defines()
                      for s in solves.values() for c in s.values()})
    t0 = time.perf_counter()
    _native.build_variants("cohort_round", defines)
    log(f"  built {len(defines)} variant libraries of cohort_round in "
        f"parallel in {time.perf_counter() - t0:.1f} s")
    entries = []
    for name in VARIANTS:
        cl = CLOSURES[name]
        errs = {}
        for kind, c in solves[name].items():
            st, aux, rules, Llen = cohort_problem(kind, True, 512, 1, "cuda")
            errs[kind] = round_checks(f"{name} {kind} 512^2 seeded",
                                      split_nodes(st, c), aux, rules, Llen,
                                      c)
        g_err, grad_err = variant_grad(cl)
        times, launches, captured = variant_erode(cl)
        log(f"  {name}: 512^2 kernel vs plain {errs} (max abs err, 1 and "
            f"16 rounds); 128^2 through run_cohort: deposits {g_err:.3e}, "
            f"gradient {grad_err:.3e}; 4096^2 step ms "
            f"{[round(t, 1) for t in times]}; launches {launches}")
        for kind, c in solves[name].items():
            e = kernel_entry(kind, captured, launches, c)
            e.update(closure=name, step_ms=times[-1],
                     max_abs_err_512=errs[kind][0],
                     max_abs_err_16_rounds_512=errs[kind][1])
            if kind == "fluvial":
                e.update(max_abs_err_run_cohort_128=g_err,
                         max_abs_err_gradient_128=grad_err)
            log(f"  {e['name']}: {e['ms']:.3f} ms/round at "
                f"{e['rounds_per_launch']} a launch, plain "
                f"{e['plain_ms']:.2f} ms at {e['plain_shape']}; "
                f"{e['registers']} registers, spills "
                f"{e['spill_store_bytes']}/{e['spill_load_bytes']} B "
                f"(stores/loads), {e['shared_bytes_per_block']} B shared a "
                f"block; {e['launches']} launches in the 2 steps")
            entries.append(e)
        del captured
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# The Monte-Carlo particle path and the host utilities
# ---------------------------------------------------------------------------


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Stopwatch:
    """While active, module.name is timed on the host clock between
    synchronises at each call (ms appended to `ms`)."""

    def __init__(self, module, name, device):
        self.module, self.name, self.device, self.ms = module, name, \
            device, []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def timed_call(*args, **kw):
            sync(self.device)
            t0 = time.perf_counter()
            out = real(*args, **kw)
            sync(self.device)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(self.module, self.name, timed_call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def state_diff(a, b):
    """Max abs difference over the fields of two states (NaN where one
    field is NaN where the other is not)."""
    import dataclasses

    import torch

    worst = 0.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not torch.equal(torch.isfinite(x), torch.isfinite(y)):
            return math.nan
        fin = torch.isfinite(x)
        if bool(fin.any()):
            worst = max(worst, float((x[fin].double() - y[fin].double())
                                     .abs().max()))
    return worst


# Phase 19(a)'s depth: maxage 128 (127 rounds a transport), cut from the
# default 512 to keep the phase near 15 s; a round costs the same at any
# depth (the particle arrays keep their size), so ms a round is the
# number to scale by (PERF.md §6). The profiled steps of 19(a) and
# 19(b) run maxage 33 (32 rounds): the profiler's processing takes ~0.15
# ms a kernel on the host, ~20 s for a 127-round 4096^2 step.
PARTICLE_MAXAGE = 128
PROFILED_MAXAGE = 33


def _with_maxage(p, maxage):
    import copy

    q = copy.copy(p)
    q.maxage = maxage
    return q


def phase_particles_full_width(n=4096, maxage=PARTICLE_MAXAGE,
                               device="cuda"):
    """transportMethod="particles" at n^2 with one particle a cell
    (nSamples = n^2), maxage `maxage` (maxage - 1 rounds a transport),
    albedo on: one warm-up and one timed step from the same state with
    the same seed (their largest difference printed: the trajectory
    kernel's deposits are atomics), then two profiled steps at 32 rounds.
    Prints ms a step and a transport, peak memory and the profiled
    step's phases and idle share inside its graph (`mark_reading`);
    returns the timed step's state."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.core.device import seeded_generator
    from soillib_tpu_torch.models import simulation

    p = soil.ErosionParams()
    p.transportMethod = "particles"
    p.nSamples = n * n
    p.maxage = maxage
    p.trackAlbedo = True
    state = soil.ErosionState.zeros((n, n), height=terrain(n, 7, device),
                                    device=device)
    erode = soil.make_erode_fn(p, (0.1, 0.1, 4.0))
    N = p.nSamples
    log(f"  memory reckoned: flux 7 x {n * n} x 4 B = "
        f"{7 * n * n * 4 / 1e6:.0f} MB; particles {N} x ~60 B = "
        f"{N * 60 / 1e9:.2f} GB (state, sources and one round's "
        f"temporaries)")

    def step(seed):
        return erode(state, seeded_generator(device, seed))

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    first, ms_first = timed(lambda: step(11))
    second, ms = timed(lambda: step(11))
    # Each transport's time, from an eager step (a replay calls no Python).
    fl = Stopwatch(simulation, "transport_fluvial", device)
    db = Stopwatch(simulation, "transport_debris", device)
    with fl, db:
        simulation.erode_step(simulation._canonicalize(state, p),
                              (0.1, 0.1, 4.0), p, seeded_generator(device, 11))
    finite_state(second, f"particles {n}^2")
    diff = state_diff(first, second)
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if torch.device(device).type == "cuda" else None)
    rounds = max(p.maxage - 1, 0)
    short = soil.make_erode_fn(_with_maxage(p, PROFILED_MAXAGE),
                               (0.1, 0.1, 4.0))
    short(state, seeded_generator(device, 12))  # captures: not profiled
    prof = (mark_reading(lambda: short(state, seeded_generator(device, 12)))
            if torch.device(device).type == "cuda" else None)
    out = {"n": n, "particles": N, "rounds": rounds,
           "first_step_ms": ms_first, "step_ms": ms,
           "fluvial_ms": fl.ms[0], "debris_ms": db.ms[0],
           "fluvial_ms_per_round": fl.ms[0] / rounds,
           "debris_ms_per_round": db.ms[0] / rounds,
           "peak_gb": peak, "same_seed_max_abs_diff": diff,
           "profiled": prof}
    log(f"  {json.dumps(out)}")
    return second, out


def particle_step_checks(fields, device_a, device_b, maxage, draws):
    """One flagship-configuration particle step from `fields` on two
    devices with the same injected births; per cell (rtol 2e-5, atol
    1e-6 of the field's largest finite magnitude) at maxage <= 16, else
    each field's total (rtol 1e-4 of the sum of magnitudes), the CPU
    tests' bars; the debris albedo times the debris mass. Returns the
    worst error as a share of its allowance."""
    from soillib_tpu_torch.testing import flagship_particle_step

    outs = [flagship_particle_step(fields, dev, maxage, draws)
            for dev in (device_a, device_b)]
    worst = 0.0
    for k in vars(outs[0]):
        got = getattr(outs[0], k).cpu().numpy().astype(np.float64)
        want = getattr(outs[1], k).cpu().numpy().astype(np.float64)
        if k == "albedo_debris":
            # A ratio of deposits, ill-conditioned where the debris mass
            # is ~nothing: compare the albedo mass it stands for, as the
            # CPU tests do.
            got = got * outs[0].debris.cpu().numpy()
            want = want * outs[1].debris.cpu().numpy()
        fin = np.isfinite(want)
        if not np.array_equal(np.isfinite(got), fin):
            raise AssertionError(f"particle step {device_a} vs {device_b} "
                                 f"maxage {maxage}: {k} non-finite "
                                 f"elsewhere")
        if maxage <= 16:
            allow = 2e-5 * np.abs(want[fin]) + 1e-6 * np.abs(
                want[fin]).max(initial=0.0)
            err = np.abs(got[fin] - want[fin])
        else:
            mag = np.abs(want[fin]).sum()
            allow = np.array([1e-4 * abs(want[fin].sum()) + 1e-4 * mag])
            err = np.array([abs(got[fin].sum() - want[fin].sum())])
        share = float((err / np.maximum(allow, 1e-300)).max(initial=0.0))
        worst = max(worst, share)
        if share > 1.0:
            raise AssertionError(
                f"particle step {device_a} vs {device_b} maxage {maxage}: "
                f"{k} outside its bar ({share:.3f} of the allowance)")
    return worst


def phase_particles_flagship(res=256, steps=32, device="cuda"):
    """The reference flagship's own configuration with particles
    (examples/erosion_tpu.py: 256^2, nSamples 8192, maxage 256; the
    example's terrain and world scale): one warm-up and `steps` timed
    steps, one step whose trajectory-kernel launches and live
    particle-rounds are counted, two profiled steps at 32 rounds read through their marks
    (`mark_reading`);
    then one
    256^2 step on the card held against the same code on the CPU with
    the same injected births, per cell at maxage 16 and by totals at
    maxage 256."""
    import soillib_tpu_torch as soil
    from soillib_tpu_torch.examples.erosion import make_param
    from soillib_tpu_torch.ops import particles
    from soillib_tpu_torch.testing import birth_draws, particle_state_fields

    p = make_param()
    p.transportMethod = "particles"
    shape = (res, res)
    pscale = (20.0 / res, 20.0 / res, 4.0)
    h = soil.noise(shape, soil.noise_t(seed=3.0, ext=shape), device=device)
    sim = soil.ErosionSim(shape, pscale, p, state=soil.ErosionState.zeros(
        shape, height=h, device=device), device=device)
    sim.step()
    _, ms = timed(lambda: sim.step(steps))
    finite_state(sim.state, f"particles flagship {res}^2")
    rounds = max(p.maxage - 1, 0)
    # One more step, its kernel launches and live particle-rounds.
    launches = live = None
    if device == "cuda":
        zero_counts(particles.particle_launches)
        particles.reset_particle_rounds()
        sim.step()
        launches = nonzero(particles.particle_launches)
        live = particles.particle_rounds()
    short = soil.make_erode_fn(_with_maxage(p, PROFILED_MAXAGE), pscale)
    short(sim.state, sim.key)  # captures: not profiled
    prof = (mark_reading(lambda: short(sim.state, sim.key))
            if device == "cuda" else None)
    fields = particle_state_fields(res, res, 5)
    draws = birth_draws(p.nSamples, 2, 6)
    cmp = {m: particle_step_checks(fields, device, "cpu", m, draws)
           for m in (16, 256)}
    out = {"res": res, "particles": p.nSamples, "rounds": rounds,
           "steps": steps, "ms_per_step": ms / steps, "profiled": prof,
           "launches": launches, "live_particle_rounds": live,
           "card_vs_cpu_worst_share": cmp}
    log(f"  {json.dumps(out)}")
    return out


# Bytes a live particle-round moves at the least (csrc/particle_rounds.cu's
# bound): the per-cell lookups at its cell and the deposits' reductions.
PARTICLE_ROUND_BYTES = {"fluvial": 20 + 28, "debris": 16 + 24}


def particle_kernel_entries(res=256, N=8192, maxage=256):
    """The trajectory kernel (csrc/particle_rounds.cu) against the plain
    loop on the same CUDA tensors at the flagship's size (res^2, N
    particles, maxage - 1 rounds; a seeded state and births), both
    estimators: per cell at rtol 2e-5 and atol 1e-6 of each channel's
    largest finite magnitude (the atomics' order; the trajectories are
    the plain loop's bit for bit), non-finite cells in the same places.
    Times the kernel (its call captured into a CUDA graph and replayed:
    the flux's fill and the launch) and the plain loop (eager), and
    returns one kernel entry a kind, with the live particle-rounds and the
    bound by bytes (PARTICLE_ROUND_BYTES a live particle-round at
    PEAK_BYTES_PER_S)."""
    import torch

    from soillib_tpu_torch.examples.erosion import make_param
    from soillib_tpu_torch.models import erosion
    from soillib_tpu_torch.ops import particles
    from soillib_tpu_torch.testing import (
        birth_draws,
        particle_round_inputs,
        particle_state_fields,
    )

    p = make_param()
    p.transportMethod, p.nSamples, p.maxage = "particles", N, maxage
    fields = particle_state_fields(res, res, 5)
    entries = []
    for kind in ("fluvial", "debris"):
        args = particle_round_inputs(kind, fields, (20.0 / res, 20.0 / res,
                                                    4.0), p, "cuda",
                                     birth_draws(N, 1, 6)[0])
        rounds0 = particles.particle_rounds()[kind]
        got = erosion._particle_rounds(**args)
        live = particles.particle_rounds()[kind] - rounds0
        want = erosion._particle_rounds_plain(**args)
        worst = 0.0
        for c in range(want.shape[0]):
            g = got[c].double().cpu().numpy()
            w = want[c].double().cpu().numpy()
            fin = np.isfinite(w)
            if not np.array_equal(np.isfinite(g), fin):
                raise AssertionError(f"particle_rounds[{kind}] channel {c}: "
                                     f"non-finite elsewhere than plain")
            allow = 2e-5 * np.abs(w[fin]) + 1e-6 * np.abs(w[fin]).max(
                initial=0.0)
            err = np.abs(g[fin] - w[fin])
            worst = max(worst, float((err / np.maximum(allow, 1e-300))
                                     .max(initial=0.0)))
        if worst > 1.0:
            raise AssertionError(f"particle_rounds[{kind}] off the plain "
                                 f"loop: {worst:.3f} of the allowance")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            erosion._particle_rounds(**args)
        ms = cuda_ms(graph.replay, 50)
        del graph
        plain_ms = cuda_ms(lambda: erosion._particle_rounds_plain(**args), 2)
        nbytes = live * PARTICLE_ROUND_BYTES[kind]
        e = {"name": f"particle_rounds[{kind}]", "ms": ms,
             "plain_ms": plain_ms, "rounds": maxage - 1, "particles": N,
             "live_particle_rounds": live, "max_err_share": worst,
             "bytes": nbytes,
             "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log(f"  particle_rounds[{kind}] {res}^2, {N} particles x "
            f"{maxage - 1} rounds: kernel {ms:.4f} ms (graph replay), plain "
            f"loop {plain_ms:.2f} ms; {live} live particle-rounds; worst "
            f"{worst:.3f} of the allowance; {json.dumps(e)}")
        entries.append(e)
    return entries


def phase_dem_particles(n=1024, device="cuda"):
    """`dem_process --particles` at n^2: the flow pipeline through the
    tile kernels (their launches counted from zero, every call held
    bitwise against plain), then solve_uniform(method="particles",
    seed=0): n^2 particles, 2n - 1 rounds."""
    import torch

    from soillib_tpu_torch.examples import dem_process
    from soillib_tpu_torch.ops import graph_tiled as gt
    from soillib_tpu_torch.ops import sweep

    argv = ["--res", str(n), "--out", "", "--particles", "--device", device]
    zero_counts(gt.tile_launches, sweep.sweep_launches, sweep.sweep_rounds)
    with Spy(gt, "local_fp_cuda") as loc, Spy(gt, "trace_cuda") as tr:
        run, ms = timed(lambda: dem_process.main(argv))
    launches = {"local": gt.tile_launches["local"],
                "trace": gt.tile_launches["trace"],
                "sweep": sweep.sweep_launches["round"]}
    out = {"launches": launches, "main_ms": ms, "ops_ms": run["ms"]}
    if device == "cuda":
        if launches != {"local": 8, "trace": 4, "sweep": 0}:
            raise AssertionError(f"dem_process --particles: launches "
                                 f"{launches}")
        errs = (tile_call_errs("dem_process --particles", "local",
                               loc.calls)[0]
                + tile_call_errs("dem_process --particles", "trace",
                                 tr.calls)[0])
        out["calls_checked_bitwise"] = {"local": len(loc.calls),
                                        "trace": len(tr.calls),
                                        "max_abs_err": max(errs)}
    q = run["discharge"]
    if tuple(q.shape) != (n, n) or not bool(torch.isfinite(q).all()) \
            or not float(q.max()) > 0.0:
        raise AssertionError("dem_process --particles: discharge not finite "
                             "and positive")
    log(f"  {json.dumps(out)}")
    return out


def phase_checkpoint(state, device="cuda"):
    """save_checkpoint / load_checkpoint of a full-width state: the round
    trip bitwise, and one field step (32 rounds) from the loaded state
    bitwise equal to one from the live state."""
    import tempfile

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.io.checkpoint import load_checkpoint, \
        save_checkpoint

    with tempfile.TemporaryDirectory() as d:
        path, ms_save = timed(lambda: save_checkpoint(d, state, 1))
        size = os.path.getsize(path)
        back, ms_load = timed(lambda: load_checkpoint(d, state, 1))
    for k, v in vars(state).items():
        bitwise_err(f"checkpoint {k}", getattr(back, k), v)
    p = soil.ErosionParams()
    p.transportIterations = 32
    live = soil.erode(state, (0.1, 0.1, 4.0), p)
    again = soil.erode(back, (0.1, 0.1, 4.0), p)
    for k, v in vars(live).items():
        bitwise_err(f"step from the checkpoint {k}", getattr(again, k), v)
    out = {"bytes": size, "save_ms": ms_save, "load_ms": ms_load}
    log(f"  checkpoint of a {tuple(state.layers.shape[1:])} state: "
        f"{json.dumps(out)}; round trip and the next step bitwise")
    return out


def phase_prefetch(n=1024, tiles=16, device="cuda"):
    """prefetch over `tiles` GeoTIFF tiles of n^2 read through
    util.iter_tiff (written here as phase 17 writes its tiles): order and
    values checked on the device; the stream consumed with a gradient and
    a reduction per tile, timed with the side stream (depth 2) and with a
    plain synchronous copy per item (put=)."""
    import tempfile

    import torch

    import soillib_tpu_torch as soil

    def read(d):
        for name, path in soil.util.iter_tiff(d):
            yield name, soil.geotiff(path).numpy()

    def consume(stream):
        names, sums = [], []
        for name, tile in stream:
            names.append(name)
            sums.append(soil.gradient(tile, (1.0, 1.0)).abs().sum())
        return names, torch.stack(sums).cpu()

    with tempfile.TemporaryDirectory() as d:
        for i in range(tiles):
            g = soil.geotiff(terrain(n, 60 + i, "cpu").numpy() * 400.0)
            g.meta.scale = [1.0, 1.0, 1.0]
            g.write(os.path.join(d, f"tile{i:02d}.tiff"))
        host = list(read(d))
        got = list(soil.prefetch(read(d), depth=2, device=device))
        if [nm for nm, _ in got] != [nm for nm, _ in host]:
            raise AssertionError("prefetch: tiles out of order")
        for (nm, a), (_, want) in zip(got, host):
            if a.device.type != torch.device(device).type or \
                    not np.array_equal(a.cpu().numpy(), want):
                raise AssertionError(f"prefetch: {nm} differs")
        del got
        (names_a, side), ms_side = timed(lambda: consume(
            soil.prefetch(read(d), depth=2, device=device)))
        (names_b, plain), ms_plain = timed(lambda: consume(
            soil.prefetch(read(d), depth=2, put=lambda item: (
                item[0], torch.from_numpy(item[1]).to(device)))))
    if names_a != names_b or not torch.equal(side, plain):
        raise AssertionError("prefetch: the side stream changed the result")
    out = {"tiles": tiles, "n": n, "side_stream_ms": ms_side,
           "plain_copy_ms": ms_plain}
    log(f"  prefetch of {tiles} GeoTIFF tiles of {n}^2: {json.dumps(out)}")
    return out


def phase_native(n=256, seed=43):
    """Whether the native library was built and is used (the build's
    error on a line of its own if not), and the decode time of an LZW
    tile (n^2 float32) through the codec's strip decoder against the
    pure-Python decoder."""
    from soillib_tpu_torch import native
    from soillib_tpu_torch.io import tiffcore
    from soillib_tpu_torch.testing import lzw_encode

    raw = (terrain(n, seed, "cpu").numpy() * 400.0).astype(np.float32)
    raw = np.round(raw).tobytes()  # a DEM of whole metres compresses
    enc = lzw_encode(raw)
    out = {"available": native.available(), "tile_bytes": len(raw),
           "lzw_bytes": len(enc)}
    if not out["available"]:
        log(f"native library: build FAILED ({native.build_error()}); the "
            f"codec and the mesh run their Python paths")
    t0 = time.perf_counter()
    dec = tiffcore._decompress(enc, 5, len(raw))
    out["codec_decode_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    py = tiffcore._unpack_lzw(enc)
    out["python_decode_ms"] = (time.perf_counter() - t0) * 1e3
    if dec != raw or py != raw:
        raise AssertionError("LZW decode differs from the tile")
    if out["available"]:
        calls = []
        with Spy(tiffcore, "_unpack_lzw") as sp:
            tiffcore._decompress(enc, 5, len(raw))
            calls = sp.calls
        out["codec_used_native"] = not calls
        if calls:
            raise AssertionError("the codec fell back to Python with the "
                                 "native library loaded")
    log(f"  native library: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Sharded execution (soillib_tpu_torch.parallel): child ranks spawned by
# parallel.launch. The rank_* functions run in every rank (a spawned
# process imports this file as its main module); a rank that raises makes
# the launcher raise, and nothing here catches it.
# ---------------------------------------------------------------------------


def zero_rank_counts():
    """Every kernel launch count of this process set to 0."""
    from soillib_tpu_torch.ops import cohort, sweep
    from soillib_tpu_torch.ops import graph_tiled as gt

    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds,
                gt.tile_launches, sweep.sweep_launches, sweep.sweep_rounds)


def rank_counts():
    """This process's kernel launches since `zero_rank_counts`."""
    from soillib_tpu_torch.ops import cohort, sweep
    from soillib_tpu_torch.ops import graph_tiled as gt

    return {**nonzero(cohort.cohort_round_launches),
            **{f"tile_{k}": v for k, v in gt.tile_launches.items() if v},
            **({"sweep": sweep.sweep_launches["round"]}
               if sweep.sweep_launches["round"] else {})}


def sync_ranks(mesh):
    """Wait for this rank's card work, then for every rank."""
    import torch

    torch.cuda.synchronize(mesh.device)
    mesh.all_reduce(torch.zeros(1, device=mesh.device))


def block_of(mesh, a):
    """This rank's block of a global field (parallel.shard_field)."""
    from soillib_tpu_torch import parallel as par

    return par.shard_field(a, mesh)


def state_block_diffs(mesh, got, want):
    """Per field: (max abs, max relative difference, bitwise, within
    tests/test_parallel.py's bar |got - want| <= 1e-5 + 1e-4 |want|) of a
    block state against the same block of a single-device state."""
    import dataclasses

    import torch

    out = {}
    for f in dataclasses.fields(got):
        g = getattr(got, f.name)
        w = block_of(mesh, getattr(want, f.name))
        if g.shape != w.shape:
            raise AssertionError(f"{f.name}: block {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        d = (g.double() - w.double()).abs()
        rel = d / w.double().abs().clamp(min=1e-30)
        out[f.name] = (float(d.max()), float(rel.max()),
                       bool(torch.equal(g.view(torch.int32),
                                        w.view(torch.int32))),
                       bool((d <= 1e-5 + 1e-4 * w.double().abs()).all()))
    return out


def rank0_spies(mesh, *targets):
    """A context recording every call of each (module, name) on rank 0
    (`Spy`), nothing elsewhere; yields the spies (empty off rank 0)."""
    import contextlib

    stack = contextlib.ExitStack()
    spies = [stack.enter_context(Spy(m, n)) for m, n in targets] \
        if mesh.rank == 0 else []
    return stack, spies


def rank_nccl_1x1(mesh, n):
    """21(a): a 1 x 1 mesh over NCCL at n^2, one step at 32 rounds and one
    with transportTol 1e-6 at the default depth, each bitwise against
    the single-device step (`erode_step`, eager) on the card."""
    import soillib_tpu_torch as soil
    from soillib_tpu_torch import parallel as par
    from soillib_tpu_torch.models.simulation import erode_step

    st = soil.ErosionState.zeros((n, n), height=terrain(n, 7, mesh.device),
                                 device=mesh.device)
    out = {"transport": mesh.transport_name}
    for name, kw in (("32 rounds", {"transportIterations": 32}),
                     ("transportTol 1e-6", {"transportIterations": 0,
                                            "transportTol": 1e-6})):
        p = soil.ErosionParams()
        for k, v in kw.items():
            setattr(p, k, v)
        zero_rank_counts()
        got, ms = timed(lambda: par.sharded_erode(st, mesh, (0.1, 0.1, 4.0),
                                                  p))
        counts = rank_counts()
        want = erode_step(st, (0.1, 0.1, 4.0), p)
        diffs = state_block_diffs(mesh, got, want)
        bad = [f for f, d in diffs.items() if not d[2]]
        if bad:
            raise AssertionError(f"21(a) {name}: the 1 x 1 NCCL step differs "
                                 f"from erode's in {bad}: {diffs}")
        out[name] = {"ms": ms, "launches": counts}
    return out


def headline_state(n, device):
    """bench.py's inputs at n^2: noise terrain, constant rain and uplift,
    white albedos."""
    import soillib_tpu_torch as soil

    height = soil.noise((n, n), soil.noise_t(), device=device) * 0.5 + 1.0
    return soil.ErosionState.zeros((n, n), height=height, rainfall=1.0,
                                   uplift=0.0, albedo_bedrock=(1.0, 1.0, 1.0),
                                   albedo_surface=(1.0, 1.0, 1.0),
                                   device=device)


def rank_step_2x2(mesh, n, iters):
    """21(b): the headline step (bench.py's inputs, default parameters,
    albedo on) at n^2 on this rank's block. Step 1 is recorded on rank 0
    (every cohort and sweep call, for the plain checks) and held against
    the single-device step (each rank computes it and compares its own
    block); step 2 is timed; step 3 runs under the timed halo ledger."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch import parallel as par
    from soillib_tpu_torch.models.simulation import _canonicalize, erode_step
    from soillib_tpu_torch.ops import cohort, sweep
    from soillib_tpu_torch.parallel import halo

    dev = mesh.device
    p = soil.ErosionParams()
    p.transportIterations = iters
    p.trackAlbedo = True
    scale = (0.078, 0.078, 4.0)
    state = headline_state(n, dev)
    block = par.shard_state(state, mesh)
    fn = par.make_sharded_erode_fn(mesh, scale, p)
    zero_rank_counts()
    stack, spies = rank0_spies(mesh, (cohort, "cohort_advance_cuda"),
                               (sweep, "transport_advance_cuda"))
    with stack:
        got = fn(block)
        sync_ranks(mesh)
    counts = rank_counts()
    want = erode_step(_canonicalize(state, p), scale, p)
    diffs = state_block_diffs(mesh, got, want)
    del want, state
    checks = []
    if spies:
        sc, ss = spies
        if not sc.calls:
            raise AssertionError("21(b): no cohort kernel call on rank 0")
        for i, (args, out) in enumerate(sc.calls):
            st, aux, rules, r, Llen, _, cl, G = args
            ref = cohort.cohort_advance_reference(st, aux, rules, r, Llen,
                                                  closure=cl, G=G)
            checks.append(max(
                bitwise_err(f"21(b) cohort call {i} state", out[0], ref[0]),
                bitwise_err(f"21(b) cohort call {i} deposits", out[1],
                            ref[1])))
            del ref
        checks += sweep_call_errs("21(b)", ss.calls)
        shapes = [list(a[0].shape) for a, _ in sc.calls]
        del sc.calls, ss.calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sync_ranks(mesh)
    got2, ms = timed(lambda: fn(got))
    sync_ranks(mesh)
    peak = torch.cuda.max_memory_allocated(dev)
    with halo.halo_ledger(timed=True) as entries:
        t0 = time.perf_counter()
        fn(got2)
        torch.cuda.synchronize(dev)
        ledger_ms = (time.perf_counter() - t0) * 1e3
        ledger = list(entries)
    finite_state(got2, "21(b) step 2")
    out = {"transport": mesh.transport_name, "rank": mesh.rank,
           "diffs": diffs, "launches": counts, "ms": ms,
           "peak_bytes": peak, "ledger_step_ms": ledger_ms,
           "exchange_ms": 1e3 * sum(e[3] for e in ledger),
           "exchanges": len(ledger),
           "payload_bytes": sum(e[1] for e in ledger),
           "sent_bytes": sum(e[2] for e in ledger)}
    if spies:
        out["plain_checks"] = {"calls": len(checks), "max_abs_err":
                               max(checks) if checks else None,
                               "cohort_call_shapes": shapes}
    return out


def rank_examples(mesh):
    """21(c) and (d): the port's pod examples at their own defaults."""
    from soillib_tpu_torch.examples import dem_mc_pod, erosion_pod

    out = {"transport": mesh.transport_name}
    zero_rank_counts()
    t0 = time.perf_counter()
    lines, ms = erosion_pod.run(mesh, erosion_pod.parse([]))
    out["erosion_pod"] = {"lines": lines, "ms_per_step": ms,
                          "launches": rank_counts(),
                          "s": time.perf_counter() - t0}
    zero_rank_counts()
    t0 = time.perf_counter()
    lines, res = dem_mc_pod.run(mesh, dem_mc_pod.parse([]))
    out["dem_mc_pod"] = {"lines": lines, "result": res,
                         "s": time.perf_counter() - t0}
    return out


def rank_accumulate(mesh, flow, area, decayed, n_solve):
    """21(e): the distributed accumulate of the DEM path's 4096^2 graph
    (phase 6's terrain), plain and decayed, against phase 6's
    single-device results (each rank its block, rtol 1e-5 / atol 1e-4),
    every tile call on rank 0 held against its plain fixed point; then the
    sharded solve_uniform at n_solve^2 (2 * n_solve rounds) against the
    single-device solve on rank 0, bitwise, every sweep call on rank 0 held
    against the plain rounds."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch import parallel as par
    from soillib_tpu_torch.ops import graph_tiled as gt
    from soillib_tpu_torch.ops import sweep

    dev = mesh.device
    out = {"transport": mesh.transport_name}
    fb = block_of(mesh, flow)
    rain = torch.ones(fb.shape, device=dev)
    zero_rank_counts()
    stack, spies = rank0_spies(mesh, (gt, "local_fp_cuda"),
                               (gt, "trace_cuda"))
    with stack:
        sync_ranks(mesh)
        a, out["accumulate_ms"] = timed(
            lambda: par.graph.accumulate(fb, rain, soil.d8, mesh=mesh))
        sync_ranks(mesh)
        d, out["accumulate_decay_ms"] = timed(
            lambda: par.graph.accumulate(fb, rain, soil.d8, mesh=mesh,
                                         decay=0.9999))
    out["accumulate_launches"] = rank_counts()
    out["accumulate_err"] = max(
        check_close("21(e) accumulate", a, block_of(mesh, area), 1e-5, 1e-4),
        check_close("21(e) accumulate_decay", d, block_of(mesh, decayed),
                    1e-5, 1e-4))
    if spies:
        loc, tr = spies
        if not loc.calls or not tr.calls:
            raise AssertionError("21(e): no tile kernel call on rank 0")
        el, _ = tile_call_errs("21(e)", "local", loc.calls)
        et, _ = tile_call_errs("21(e)", "trace", tr.calls)
        out["tile_checks"] = {"local": len(loc.calls), "trace": len(tr.calls),
                              "max_abs_err": max(el + et)}
        del loc.calls, tr.calls
    del a, d, fb, rain
    torch.cuda.empty_cache()

    n = n_solve
    h = terrain(n, 19, dev) * 400.0
    grad = soil.gradient(soil.fill_depressions(h), (90.0, 90.0))
    velocity = -grad / torch.clamp(
        torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-6)
    ones = torch.ones((n, n), device=dev)
    evap = torch.full((n, n), 0.001, device=dev)
    zero_rank_counts()
    stack, spies = rank0_spies(mesh, (sweep, "transport_advance_cuda"))
    with stack:
        sync_ranks(mesh)
        G, out["solve_ms"] = timed(lambda: par.ops.solve_uniform(
            par.shard_field(velocity, mesh, ("X", "Y", None)),
            block_of(mesh, ones), block_of(mesh, evap), (90.0, 90.0),
            mesh=mesh))
    out["solve_launches"] = rank_counts()
    G = par.gather_field(G, mesh)
    if mesh.rank == 0:
        want = soil.solve_uniform(velocity, ones, evap, (90.0, 90.0))
        out["solve_err"] = bitwise_err("21(e) sharded solve_uniform", G,
                                       want)
    if spies:
        if not spies[0].calls:
            raise AssertionError("21(e): no sweep kernel call on rank 0")
        errs = sweep_call_errs("21(e)", spies[0].calls)
        out["sweep_checks"] = {"calls": len(errs), "max_abs_err": max(errs)}
    return out


def phase_sharded(dem_keep):
    """Phase 21 (see main): returns the launches each sharded path made,
    summed over its ranks, by kernel."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch import parallel as par
    from soillib_tpu_torch.core.device import seeded_generator
    from soillib_tpu_torch.examples import dem_mc_pod
    from soillib_tpu_torch.models import erosion as ero
    from soillib_tpu_torch.ops import transport

    def total(results, key):
        out = {}
        for r in results:
            for k, v in r[key].items():
                out[k] = out.get(k, 0) + v
        return out

    paths = {}
    t0 = time.perf_counter()
    (a,) = par.launch(rank_nccl_1x1, 1, transport="nccl",
                      devices=["cuda:0"], args=(1024,), timeout=600)
    log(f"  (a) 1 x 1 mesh, transport {a['transport']}, 1024^2: "
        + "; ".join(f"{k} bitwise equal to erode's step ({v['ms']:.1f} ms, "
                    f"launches {v['launches']})"
                    for k, v in a.items() if k != "transport")
        + f"; {time.perf_counter() - t0:.1f} s with the rank's start")
    paths["sharded 1x1 nccl 1024^2 (2 steps)"] = total(
        [a["32 rounds"], a["transportTol 1e-6"]], "launches")

    t0 = time.perf_counter()
    b = par.launch(rank_step_2x2, 4, transport="gloo",
                   devices=["cuda:0"] * 4, args=(4096, 32), timeout=900)
    worst = {}
    for r in b:
        for f, (d, rel, bit, ok) in r["diffs"].items():
            w = worst.get(f, (0.0, 0.0, True, True))
            worst[f] = (max(w[0], d), max(w[1], rel), w[2] and bit,
                        w[3] and ok)
    bitwise = all(w[2] for w in worst.values())
    for f, (d, rel, bit, ok) in worst.items():
        if not ok:
            raise AssertionError(f"21(b) {f}: max abs {d:.3e}, max rel "
                                 f"{rel:.3e}, outside rtol 1e-4 / atol 1e-5")
    chk = b[0]["plain_checks"]
    log(f"  (b) 2 x 2 mesh, 4 ranks on the one card, transport "
        f"{b[0]['transport']}, 4096^2 headline step (32 rounds, albedo on) "
        f"vs the single-device step: "
        f"{'bitwise equal' if bitwise else 'within rtol 1e-4 / atol 1e-5'};"
        f" worst per field [max abs, max rel] "
        f"{json.dumps({f: [w[0], w[1]] for f, w in worst.items()})}")
    log(f"  (b) rank 0's {chk['calls']} cohort/sweep calls bitwise equal to "
        f"the plain rounds on their padded blocks "
        f"{chk['cohort_call_shapes'][:1]} (max abs err {chk['max_abs_err']})")
    for r in b:
        log(f"  (b) rank {r['rank']}: {r['ms']:.1f} ms a step; exchanges "
            f"{r['exchange_ms']:.1f} ms of a {r['ledger_step_ms']:.1f} ms "
            f"step synchronised around each ({r['exchanges']} exchanges, "
            f"{r['exchange_ms'] / r['ledger_step_ms']:.1%}); halo "
            f"{r['sent_bytes']} B sent ({r['payload_bytes']} B payload); peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; launches {r['launches']}")
    log(f"  (b) {time.perf_counter() - t0:.1f} s with the ranks' start")
    paths["sharded 2x2 4096^2 step"] = total(b, "launches")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    c = par.launch(rank_examples, 4, transport="gloo",
                   devices=["cuda:0"] * 4, timeout=900)
    ep = c[0]["erosion_pod"]
    log(f"  (c) erosion_pod 2 x 2 on the one card, transport "
        f"{c[0]['transport']}: " + " | ".join(ep["lines"])
        + f"; {ep['s']:.1f} s in all")
    paths["erosion_pod 2x2 1024^2 (128 steps)"] = total(
        [r["erosion_pod"] for r in c], "launches")
    mc = c[0]["dem_mc_pod"]
    res = mc["result"]
    log(f"  (d) dem_mc_pod 2 x 2 on the one card, transport "
        f"{c[0]['transport']}: " + " | ".join(mc["lines"]))
    if res["dropped"] != {"uniform": 0, "fluvial": 0}:
        raise AssertionError(f"21(d) dropped particles: {res['dropped']}")
    args = dem_mc_pod.parse([])
    flow, source, decay, state = dem_mc_pod.problem((args.res, args.res),
                                                    "cuda")
    N = 16 * args.res * args.res
    (G, g_ms) = timed(lambda: transport._solve_particles(
        flow, source, decay, (0.5, 0.5), N, seeded_generator("cuda", 0),
        2 * args.res))
    F, f_ms = timed(lambda: ero._fluvial_particles(
        state.layers, state.rainfall, state.discharge, state.momentum,
        state.albedo_surface, (0.5, 0.5, 2.0), dem_mc_pod.fluvial_params(N),
        seeded_generator("cuda", 1)).reshape(7, args.res, args.res))
    G, F = G.cpu().numpy(), F.cpu().numpy()
    got_g, got_f = res["uniform"], res["fluvial"]
    corr = float(np.corrcoef(got_g.ravel(), G.ravel())[0, 1])
    tot = abs(float(got_g.sum()) - float(G.sum())) / abs(float(G.sum()))
    mrel = float(np.abs(got_g - G).mean() / np.abs(G).mean())
    if not (corr >= 0.999 and tot <= 1e-4 and mrel < 0.01):
        raise AssertionError(f"21(d) uniform MC vs single-device: corr "
                             f"{corr}, total rel {tot}, mean rel {mrel}")
    # The water, mass and momentum channels (tests/test_parallel.py's
    # fluvial bars); the mass channel of a state at rest is zero in both.
    # The sharded flux is channel-last (W, H, 7), as the JAX package's.
    got_f = np.moveaxis(got_f, -1, 0)
    fcorr = {ch: float(np.corrcoef(got_f[ch].ravel(), F[ch].ravel())[0, 1])
             for ch in (0, 1, 2, 3) if F[ch].std() > 0.0}
    ftot = abs(float(got_f[0].sum()) - float(F[0].sum())) / abs(
        float(F[0].sum()))
    zero = [ch for ch in (0, 1, 2, 3) if ch not in fcorr]
    if (min(fcorr.values()) < 0.99 or ftot > 5e-3
            or any(got_f[ch].std() > 0.0 for ch in zero)):
        raise AssertionError(f"21(d) fluvial MC vs single-device: corr "
                             f"{fcorr}, water total rel {ftot}, channels "
                             f"{zero} constant in the single-device run")
    log(f"  (d) vs the single-device estimators on the card, same "
        f"generators: uniform corr {corr:.6f}, total rel {tot:.2e}, mean "
        f"rel {mrel:.2e} ({g_ms:.0f} ms single-device); fluvial corr "
        f"{fcorr}, water total rel {ftot:.2e} ({f_ms:.0f} ms); sharded "
        f"uniform {res['seconds']['uniform']:.2f} s, fluvial "
        f"{res['seconds']['fluvial']:.2f} s; {mc['s']:.1f} s in all")
    del flow, source, decay, state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    e = par.launch(rank_accumulate, 4, transport="gloo",
                   devices=["cuda:0"] * 4,
                   args=(dem_keep["flow"], dem_keep["area"],
                         dem_keep["decayed"], 1024), timeout=900)
    e0 = e[0]
    log(f"  (e) accumulate 4096^2 2 x 2 ({e0['transport']}): "
        f"{e0['accumulate_ms']:.0f} ms, decayed {e0['accumulate_decay_ms']:.0f}"
        f" ms on rank 0; max abs err vs the single-device results "
        f"{max(r['accumulate_err'] for r in e):.3e} (rtol 1e-5 / atol 1e-4); "
        f"rank 0's {e0['tile_checks']['local']} push and "
        f"{e0['tile_checks']['trace']} trace calls bitwise equal to the "
        f"plain fixed points")
    log(f"  (e) solve_uniform 1024^2, 2048 rounds, 2 x 2: "
        f"{e0['solve_ms']:.0f} ms; bitwise equal to the single-device solve "
        f"(max abs err {e0['solve_err']}); rank 0's "
        f"{e0['sweep_checks']['calls']} sweep calls bitwise equal to the "
        f"plain rounds; {time.perf_counter() - t0:.1f} s with the ranks' "
        f"start")
    paths["sharded accumulate 2x2 4096^2 (plain + decay)"] = total(
        e, "accumulate_launches")
    paths["sharded solve_uniform 2x2 1024^2"] = total(e, "solve_launches")
    return paths


# ---------------------------------------------------------------------------
# Phase 22: the compiled driver (make_erode_fn, erode, ErosionSim: one step
# captured as a CUDA graph and replayed) against the eager erode_step
# ---------------------------------------------------------------------------


def release_compiled():
    """Drops make_erode_fn's compiled steps (graphs, memory pools, buffers)
    and hands torch's cached memory back to the card."""
    import torch

    from soillib_tpu_torch.models import simulation

    simulation._compiled.clear()
    torch.cuda.empty_cache()


def compiled_configs():
    """Phase 22's configurations: (label, what, make), make() -> (params,
    state, scale)."""
    import soillib_tpu_torch as soil
    from soillib_tpu_torch.examples import multiscale
    from soillib_tpu_torch.examples.erosion import make_param

    def bench(auto):
        p = soil.ErosionParams()
        p.trackAlbedo = True
        if auto:
            p.transportIterations, p.transportTol = 0, 1e-6
        else:
            p.transportIterations = 32
        return p, headline_state(4096, "cuda"), (0.078, 0.078, 4.0)

    def noise_state(n):
        return soil.ErosionState.zeros((n, n), height=soil.noise(
            (n, n), soil.noise_t(seed=3.0, ext=(n, n))))

    def cascade():
        p = make_param()
        return p, noise_state(128), soil.level_scale(
            multiscale.WORLD, multiscale.ZSCALE, (128, 128))

    def flagship(particles):
        p = make_param()
        if particles:
            p.transportMethod = "particles"
        return p, noise_state(256), (20.0 / 256, 20.0 / 256, 4.0)

    def field_static():
        p = soil.ErosionParams()
        p.transportIterations = 32
        p.trackAlbedo = True
        p.transportMethod = "field-static"
        return (p, soil.ErosionState.zeros((4096, 4096),
                                           height=terrain(4096, 23)),
                (0.1, 0.1, 4.0))

    def quality():
        return (quality_params(32), soil.ErosionState.zeros(
            (1024, 1024), height=terrain(1024, 37)), (0.1, 0.1, 4.0))

    return [
        ("a", "bench inputs 4096^2, 32 rounds, albedo on",
         lambda: bench(False)),
        ("b", "bench inputs 4096^2, auto (transportTol 1e-6, 510 rounds "
              "at most)", lambda: bench(True)),
        ("c", "the cascade's 128^2 level (its parameters, 64 rounds)",
         cascade),
        ("d", "flagship field step 256^2, 64 rounds", lambda: flagship(False)),
        ("e", "flagship particle step 256^2, 8192 particles, maxage 256",
         lambda: flagship(True)),
        ("f", "field-static 4096^2, 32 rounds", field_static),
        ("g", "CohortClosure(nodes=4, colors=8) 1024^2, 32 rounds", quality),
    ]


def bits_differ(a, b):
    """The fields of two states whose bit patterns differ (NaN included)."""
    import dataclasses

    import torch

    return [f.name for f in dataclasses.fields(a) if not torch.equal(
        getattr(a, f.name).contiguous().view(torch.int32),
        getattr(b, f.name).contiguous().view(torch.int32))]


def peak_gb():
    """[peak allocated, peak reserved] GB since the last reset, and resets
    them (a graph's pool is reserved memory)."""
    import torch

    out = [torch.cuda.max_memory_allocated() / 1e9,
           torch.cuda.max_memory_reserved() / 1e9]
    torch.cuda.reset_peak_memory_stats()
    return out


def compiled_vs_eager(label, what, make, steps=4, seed=5,
                      deterministic=False):
    """One configuration of phase 22: `steps` eager erode_steps and
    `steps` replays of the compiled step (one call a step) from the same
    state and generator, held bitwise on every field after the last, with
    the launch counters of each (counted from zero) and the generator's
    state; then `steps` replays with donate=True, bitwise too. ms a step
    of steps 2.. for each path (host clock between synchronises; the
    compiled path's first call, which captures, apart), two profiled
    replays of the compiled step read through their marks (`mark_reading`:
    phases and the idle share inside the graph), warm-up, capture and
    instantiate seconds, and peak memory
    with donate=False and with donate=True, of the first call (which
    captures) and of the steps after it (allocated, and reserved: a
    graph's pool is reserved). With
    `deterministic` both paths run under
    torch.use_deterministic_algorithms (the particle kernel's deposits
    add with atomics otherwise; under it the kernel runs a round a launch
    into torch's deterministic index_add_), and two eager runs without
    it are compared as well. Returns (record, failures)."""
    import torch

    import soillib_tpu_torch as soil
    from soillib_tpu_torch.core.device import seeded_generator
    from soillib_tpu_torch.core.graphs import launch_counters
    from soillib_tpu_torch.models import simulation

    release_compiled()
    p, state, scale = make()
    counters = launch_counters()
    fails = []
    rec = {"what": what, "deterministic_algorithms": deterministic}

    def eager_run():
        key = seeded_generator("cuda", seed)
        e, times = simulation._canonicalize(state, p), []
        for _ in range(steps):
            e, ms = timed(lambda e=e: simulation.erode_step(e, scale, p,
                                                           key))
            times.append(ms)
        return e, key, times

    if deterministic:
        e0, _, _ = eager_run()
        e1, _, _ = eager_run()
        rec["eager_vs_eager_default"] = {"fields_differ": bits_differ(e0, e1),
                                         "max_abs": state_diff(e0, e1)}
        del e0, e1
    torch.use_deterministic_algorithms(deterministic)
    try:
        zero_counts(*counters)
        e, key, eager_ms = eager_run()
        eager_counts = [nonzero(c) for c in counters]

        zero_counts(*counters)
        torch.cuda.reset_peak_memory_stats()
        gen = seeded_generator("cuda", seed)
        fn = soil.make_erode_fn(p, scale, 1)
        c, first_ms = timed(lambda: fn(state, gen))
        rec["peak_gb_first_call_donate_false"] = peak_gb()
        compiled_ms = []
        for _ in range(steps - 1):
            c, ms = timed(lambda c=c: fn(c, gen))
            compiled_ms.append(ms)
        compiled_counts = [nonzero(x) for x in counters]
        rec["peak_gb_donate_false"] = peak_gb()
        (step,) = simulation._compiled.values()
        stats = {k: getattr(step, k) for k in ("warmup_s", "capture_s",
                                               "instantiate_s")}
        del step
        differ = bits_differ(c, e)
        if differ:
            fails.append(f"({label}) compiled differs from eager after "
                         f"{steps} steps in {differ}: max abs "
                         f"{state_diff(c, e):.3e}")
        if compiled_counts != eager_counts:
            fails.append(f"({label}) launch counters: compiled "
                         f"{compiled_counts}, eager {eager_counts}")
        if not torch.equal(gen.get_state(), key.get_state()):
            fails.append(f"({label}) the generators differ after the steps")
        marks_c = mark_reading(lambda: fn(c, gen))
        del c
        release_compiled()

        torch.cuda.reset_peak_memory_stats()
        gen = seeded_generator("cuda", seed)
        fn_d = soil.make_erode_fn(p, scale, 1, donate=True)
        d, donate_ms = fn_d(state, gen), []
        rec["peak_gb_first_call_donate_true"] = peak_gb()
        for _ in range(steps - 1):
            d, ms = timed(lambda d=d: fn_d(d, gen))
            donate_ms.append(ms)
        rec["peak_gb_donate_true"] = peak_gb()
        differ = bits_differ(d, e)
        if differ:
            fails.append(f"({label}) donate=True differs from eager in "
                         f"{differ}")
    finally:
        torch.use_deterministic_algorithms(False)
    del d, e, state
    release_compiled()
    eager_step = float(np.mean(eager_ms[1:]))
    compiled_step = float(np.mean(compiled_ms))
    rec.update({
        "bitwise_after_steps": steps if not fails else None,
        "eager_ms": eager_ms, "compiled_first_call_ms": first_ms,
        "compiled_ms": compiled_ms, "donate_ms": donate_ms,
        "eager_ms_per_step": eager_step,
        "compiled_ms_per_step": compiled_step, **stats,
        "launches": eager_counts[0], "cohort_rounds": eager_counts[1],
        "sweep_launches": eager_counts[2],
        "compiled_launches": compiled_counts[0],
        "compiled_sweep_launches": compiled_counts[2],
        "compiled_particle_launches": compiled_counts[5],
        "marks_compiled": marks_c})
    log(f"  ({label}) {what}: {'bitwise equal' if not fails else 'FAILED'}"
        f" after {steps} steps; ms a step (steps 2-{steps}) eager "
        f"{eager_step:.3f}, compiled {compiled_step:.3f} (first call "
        f"{first_ms:.1f}: warm-up {stats['warmup_s']:.2f} s, capture "
        f"{stats['capture_s']:.2f} s, instantiate "
        f"{stats['instantiate_s']:.2f} s), donate "
        f"{np.mean(donate_ms):.3f}; compiled step's marks (profiled) "
        f"{json.dumps(marks_c)}; peak GB "
        f"(allocated, reserved) of the steps after the first call "
        f"donate=False {rec['peak_gb_donate_false']}, donate=True "
        f"{rec['peak_gb_donate_true']} (of the first call "
        f"{rec['peak_gb_first_call_donate_false']}, "
        f"{rec['peak_gb_first_call_donate_true']}); counters "
        f"{eager_counts[:3]}"
        + (f"; two eager runs without deterministic algorithms: "
           f"{rec['eager_vs_eager_default']}" if deterministic else ""))
    return rec, fails


def state_copy_ms(n=4096):
    """Device ms of one copy of the bench's 4096^2 state into buffers of
    its own shape (what the captured step's write-back does each replay),
    and its bytes."""
    import torch

    from soillib_tpu_torch.models import simulation

    p = simulation.ErosionParams()
    p.trackAlbedo = True
    st = simulation._canonicalize(headline_state(n, "cuda"), p)
    src = [getattr(st, f).contiguous() for f in simulation.FIELDS]
    dst = [torch.empty_like(t) for t in src]

    def copy():
        for a, b in zip(dst, src):
            a.copy_(b)

    nbytes = sum(t.numel() * 4 for t in src)
    return cuda_ms(copy, 10), nbytes


def phase_compiled():
    """Phase 22: every configuration of `compiled_configs` through
    `compiled_vs_eager`; raises after all of them if any failed."""
    out, fails = {}, []
    # The kernels each configuration's compiled steps must launch.
    need = {"a": ("fluvial", "debris"), "b": ("fluvial", "debris"),
            "c": ("fluvial", "debris"), "d": ("fluvial", "debris"),
            "e": (), "f": ("debris", "sweep"),
            "g": ("fluvial,nodes=4", "debris")}
    for label, what, make in compiled_configs():
        rec, f = compiled_vs_eager(label, what, make,
                                   deterministic=label == "e")
        out[label] = rec
        fails += f
        got = {**rec["compiled_launches"],
               **({"sweep": rec["compiled_sweep_launches"]["round"]}
                  if rec["compiled_sweep_launches"] else {})}
        missing = [k for k in need[label] if not got.get(k)]
        if missing:
            fails.append(f"({label}) the compiled steps launched no "
                         f"{missing} kernel: {got}")
    ms, nbytes = state_copy_ms()
    out["state_copy_4096"] = {"ms": ms, "bytes": nbytes}
    log(f"  a copy of the 4096^2 bench state (albedo on, compact rain and "
        f"uplift): {nbytes / 1e9:.3f} GB read and written in {ms:.3f} ms")
    if fails:
        raise AssertionError("phase 22: " + "; ".join(fails))
    return out


def record_solves():
    """While active, the inputs and deposits of every eager cohort solve
    (`ops/cohort.py` `run_cohort`, outside a CUDA-graph capture, whose
    results do not exist yet) are appended to the returned list; call
    the list's `stop` to end recording."""
    import torch

    from soillib_tpu_torch.ops import cohort

    run = cohort.run_cohort
    solves = []

    def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        out = run(st0, aux, rules, iters, Llen, closure, tol)
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            solves.append((cohort.as_stack(st0).clone(),
                           cohort.as_stack(aux).clone(), rules, int(iters),
                           Llen, closure, tol, out.clone()))
        return out

    def stop():
        cohort.run_cohort = run

    cohort.run_cohort = spy
    return solves, stop


def leaves(tree, prefix=()):
    """(key path, value) of every leaf of a nested dict."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [kv for k, v in tree.items() for kv in leaves(v, prefix + (k,))]


def phase_parity(size=256, terrains=("noise", "steep"), seeds=4, steps=4,
                 n_rep=2, probe_size=48):
    """The transport-parity harness (soillib_tpu_torch.benchmarks.parity)
    at `size`, cold and warm, `steps` coupled steps with `n_rep` particle
    runs: every metric finite, the JAX harness's keys, each eager field
    solve of the phase (kernel 1) bitwise against the plain rounds on its
    inputs; then the age-deficit probe's per-round trace at `probe_size`
    (one kernel launch a round) bitwise against the plain rounds'."""
    import torch

    from soillib_tpu_torch.benchmarks import age_deficit_probe as adp
    from soillib_tpu_torch.benchmarks import parity as pp
    from soillib_tpu_torch.ops import cohort

    args = pp.parse_args(["--size", str(size), "--terrains",
                          ",".join(terrains), "--seeds", str(seeds),
                          "--steps", str(steps)])
    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    solves, stop = record_solves()
    try:
        report, ms = timed(lambda: pp.run(args, n_rep=n_rep,
                                          log=lambda s: log("  " + s)))
    finally:
        stop()
    launches = nonzero(cohort.cohort_round_launches)
    if pp.key_paths(report) != pp.key_paths(pp.report_skeleton(terrains)):
        raise AssertionError("parity: the report's keys are not the JAX "
                             "harness's")
    bad = [k for k, v in leaves(report) if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"parity: non-finite metrics {bad}")
    if not (launches.get("fluvial") and launches.get("debris")):
        raise AssertionError(f"parity: kernel 1 not launched: {launches}")
    # Every phase comparison's field solve, and the compiled steps'
    # eager warm-ups.
    if len(solves) < 4 * len(terrains):
        raise AssertionError(f"parity: {len(solves)} eager solves recorded")
    t0 = time.perf_counter()
    err = 0.0
    for i, (st, aux, rules, iters, Llen, closure, tol, got) in enumerate(
            solves):
        _, want = cohort.cohort_advance_reference(st, aux, rules, iters,
                                                  Llen, closure=closure,
                                                  tol=tol)
        err = max(err, bitwise_err(f"parity solve {i} ({rules.kind}, "
                                   f"{iters} rounds)", got, want))
    log(f"  parity {size}^2 ({','.join(terrains)}; {seeds} seeds, "
        f"{steps} coupled steps x {n_rep}): {ms / 1e3:.1f} s; kernel 1 "
        f"launches {launches}; {len(solves)} eager field solves bitwise "
        f"against the plain rounds ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    st = adp.warm_state(probe_size, "cuda")
    rain = adp.patch_rain(probe_size, "cuda")
    import soillib_tpu_torch as soil

    p = soil.param_t()
    p.maxage, p.timeStep = 128, 500.0
    zero_counts(cohort.cohort_round_launches, cohort.cohort_rounds)
    trace_k, G_k = adp.field_trace(st, rain, adp.SCALE, p)
    torch.cuda.synchronize()
    probe_launches = nonzero(cohort.cohort_round_launches)
    if probe_launches != {"fluvial": adp.ROUNDS}:
        raise AssertionError(f"age probe: launches {probe_launches}, "
                             f"expected one a round ({adp.ROUNDS})")
    trace_p, G_p = adp.field_trace(st, rain, adp.SCALE, p, plain=True)
    bitwise_err("age probe per-round trace", torch.from_numpy(trace_k),
                torch.from_numpy(trace_p))
    bitwise_err("age probe deposits", G_k, G_p)
    log(f"  age probe {probe_size}^2: {adp.ROUNDS} rounds, one launch "
        f"each, trace and deposits bitwise against the plain rounds "
        f"(cumulative water flux {float(trace_k.sum()):.4f}; "
        f"{time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "probe_launches": probe_launches,
            "seconds": ms / 1e3}


def phase_scaling(block=1024, iters=32, steps=2):
    """The weak-scaling harness (soillib_tpu_torch.benchmarks.scaling) with
    1 and 4 ranks sharing the card over host-staged gloo: the 4 ranks'
    timed step gathered against the single-device eager step on the same
    2*block x 2*block grid, bitwise; cell-steps/s of both under the
    card-sharing caveat. Returns kernel 1's launches in the 4 ranks'
    timed call, summed over the ranks."""
    import torch

    from soillib_tpu_torch import parallel as par
    from soillib_tpu_torch.benchmarks import scaling
    from soillib_tpu_torch.core.device import seeded_generator
    from soillib_tpu_torch.models.simulation import (
        FIELDS,
        _canonicalize,
        erode_step,
    )

    t0 = time.perf_counter()
    rate1, _ = scaling.measure(1, block, steps, iters, "gloo", ["cuda:0"])
    t1 = time.perf_counter()
    rate4, res = scaling.measure(4, block, steps, iters, "gloo",
                                 ["cuda:0"] * 4, keep=True)
    log(f"  launches: 1 rank {t1 - t0:.1f} s, 4 ranks "
        f"{time.perf_counter() - t1:.1f} s")
    for n, rate in ((1, rate1), (4, rate4)):
        log("  " + json.dumps(scaling.line(n, rate, (1, rate1),
                                           scaling.CAVEAT)))
    got = scaling.global_state(res, par.factor2(4))
    n = 2 * block
    state, scale, param = scaling.problem(n, n, iters, "cuda")
    state = _canonicalize(state, param)
    key = seeded_generator("cuda", 0)
    for _ in range(2 * steps):
        state = erode_step(state, scale, param, key)
    err = 0.0
    for name in FIELDS:
        err = max(err, bitwise_err(f"scaling 4 ranks, {name}",
                                   torch.from_numpy(got[name]).cuda(),
                                   getattr(state, name)))
    launches = {}
    for r in res:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if not (launches.get("fluvial") and launches.get("debris")):
        raise AssertionError(f"scaling: kernel 1 not launched: {launches}")
    log(f"  4 ranks' timed step ({n}^2, {steps} steps) bitwise equal to "
        f"the single-device step; kernel 1 launches over the ranks "
        f"{launches}")
    return launches


def record_first_solves():
    """While active, the inputs of the first eager cohort solve of each
    rule set ({kind: (state, aux, rules, Llen)}), copied to host memory
    as the solve runs (a compiled step's warm-up runs eagerly; its
    capture and replays call no Python); call `stop` to end recording."""
    import torch

    from soillib_tpu_torch.ops import cohort

    run = cohort.run_cohort
    first = {}

    def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        if rules.kind not in first and not (
                torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            first[rules.kind] = (cohort.as_stack(st0).cpu(),
                                 cohort.as_stack(aux).cpu(), rules, Llen)
        return run(st0, aux, rules, iters, Llen, closure, tol)

    def stop():
        cohort.run_cohort = run

    cohort.run_cohort = spy
    return first, stop


def phase_headline_8192(n=8192, iters=32, steps=4):
    """Phase 25: the bench at the JAX headline's capacity configuration
    (n^2, albedo off, `iters` rounds, `steps` timed steps) in this
    process: its keys, the 1200-byte yardstick, a finite positive value;
    then the cohort kernel built with ALBEDO=false, fluvial and debris,
    held bitwise against the plain round at 1 and 16 rounds on that run's
    own cohort inputs (its first step, the compiled step's eager warm-up)
    and timed per round there. Returns the two kernel entries (launches:
    the bench's) and the run's peak memory."""
    import torch

    from soillib_tpu_torch import bench
    from soillib_tpu_torch.ops import cohort
    from soillib_tpu_torch.ops import fp32_chain as fc

    first, stop = record_first_solves()
    zero_counts(fc.fp32_chain_launches, cohort.cohort_round_launches,
                cohort.cohort_rounds)
    torch.cuda.reset_peak_memory_stats()
    try:
        line, ms = timed(lambda: bench.main(
            ["--size", str(n), "--albedo", "off", "--iters", str(iters),
             "--steps", str(steps)]))
    finally:
        stop()
    launches = nonzero(cohort.cohort_round_launches)
    probe = nonzero(fc.fp32_chain_launches)
    peak = {"bench": peak_gb()}
    keys = {"metric", "value", "unit", "vs_baseline", "hbm_sol",
            "compute_sol", "bw_bytes_per_s", "bytes_per_cell_step",
            "fp32_ops_per_s", "fp32_ops_per_cell_step", "device"}
    if set(line) != keys:
        raise AssertionError(f"bench {n}^2 albedo off: keys {sorted(line)}")
    if not (math.isfinite(line["value"]) and line["value"] > 0):
        raise AssertionError(f"bench {n}^2 albedo off: value {line['value']}")
    if line["bytes_per_cell_step"] != 1200.0:
        raise AssertionError(f"bench {n}^2 albedo off: bytes per cell-step "
                             f"{line['bytes_per_cell_step']}, not 1200")
    if not (launches.get("fluvial") and launches.get("debris") and probe):
        raise AssertionError(f"bench {n}^2 albedo off launches: cohort "
                             f"{launches}, probe {probe}")
    if sorted(first) != ["debris", "fluvial"] or any(
            rec[2].albedo_on for rec in first.values()):
        raise AssertionError(f"bench {n}^2 albedo off: recorded solves "
                             f"{[(k, r[2].albedo_on) for k, r in first.items()]}")
    log(f"  bench {n}^2 albedo off, {iters} rounds, {steps} steps: "
        f"{ms / 1e3:.1f} s in all, {line['value']:.4e} gridpoint-steps/s "
        f"({n * n / line['value'] * 1e3:.1f} ms a step); cohort launches "
        f"{launches}, probe launches {probe}; peak memory allocated / "
        f"reserved {peak['bench'][0]:.2f} / {peak['bench'][1]:.2f} GB")
    release_compiled()
    entries = []
    for kind in ("fluvial", "debris"):
        st, aux, rules, Llen = first.pop(kind)
        captured = {kind: (st.cuda(), aux.cuda(), rules, Llen)}
        del st, aux
        # The plain round on the full 8192^2 state peaks near 62 GB: the
        # check runs once the bench's graphs are released.
        e = kernel_entry(kind, captured, launches)
        del captured
        e["name"] = f"cohort_round[{kind},albedo=off]"
        e["launches_by_path"] = {
            f"bench {n}\u00b2 albedo off (phase 25)": launches[kind]}
        log(f"  {e['name']} {'x'.join(map(str, e['shape']))}: "
            f"{e['ms']:.3f} ms/round at {e['rounds_per_launch']} rounds a "
            f"launch ({e['ms_per_round_at_1_round_a_launch']:.3f} at 1), "
            f"plain {e['plain_ms']:.2f} ms at "
            f"{'x'.join(map(str, e['plain_shape']))}; {e['registers']} "
            f"registers, {e['spill_store_bytes']} B spilled")
        entries.append(e)
        torch.cuda.empty_cache()
    peak["checks"] = peak_gb()
    log(f"  the checks' peak memory allocated / reserved "
        f"{peak['checks'][0]:.2f} / {peak['checks'][1]:.2f} GB")
    return entries, peak


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global PEAK_F32_PER_S
    from soillib_tpu_torch import _native, bench
    from soillib_tpu_torch.ops import cohort

    t_start = time.perf_counter()
    log("phase 1: device and build")
    smi = smi_line()
    log(f"  {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")
    PEAK_F32_PER_S = bench.spec_fp32_rate(
        torch.device("cuda", torch.cuda.current_device()))
    log(f"  FP32 issue rate (SMs x 128 lanes x max SM clock): "
        f"{PEAK_F32_PER_S:.4e}/s")
    t0 = time.perf_counter()
    _native.build()
    log(f"  built {_native.sources()} in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _native.sources():
        for line in _native.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernel vs plain on the card")
    phase_kernel_vs_plain()

    log("phase 3: main path, ErosionSim 4096^2, 32 rounds, 3 steps")
    sim, times, launches = phase_main_path()
    log(f"  step ms {[round(t, 1) for t in times]}; steps 2-3 mean "
        f"{np.mean(times[1:]):.1f} ms; launches {launches}")

    log("phase 4: kernel path vs plain path, erode 256^2, 2 steps")
    phase_kernel_vs_plain_erode()

    log("phase 5: faithful depth")
    phase_faithful_depth()

    log("where the time goes: one profiled 4096^2 step")
    phase_breakdown(sim)

    log("kernel vs plain and timing at the main path's inputs")
    captured = capture_solves(sim)
    entries = [kernel_entry(k, captured, launches)
               for k in ("fluvial", "debris")]
    for e in entries:
        log(f"  {e['name']}: {e['ms']:.3f} ms/round at "
            f"{e['rounds_per_launch']} rounds a launch "
            f"({e['ms_per_round_at_1_round_a_launch']:.3f} at 1), plain "
            f"{e['plain_ms']:.2f} ms; {e['registers']} registers, "
            f"{e['shared_bytes_per_block']} B shared a block, "
            f"{e['bytes_per_cell_round']:.1f} B per cell-round")
    del sim, captured

    log("phase 6: DEM path 4096^2 (fill, steepest, accumulate x2, "
        "gradient, solve_uniform 8192 rounds)")
    dem = phase_dem()

    log("phase 7: DEM kernels vs plain on the path's own inputs")
    entries += tile_entries(dem)
    accumulate_checks(dem)
    log("where the time goes: one 4096^2 accumulate")
    accumulate_breakdown(dem)
    entries.append(sweep_entry("transport_sweep[C=1]", dem["sweep"],
                               dem["launches"]["sweep"],
                               dem["launches"]["sweep_rounds"]))
    solve_uniform_check()
    # Phase 21 runs the distributed accumulate on this graph.
    dem_keep = {k: dem[k].cpu() for k in ("flow", "area", "decayed")}
    del dem

    log("phase 8: field-static, ErosionSim 4096^2, 32 rounds, 3 steps")
    fs_sim, _, fs_launches, fs_rounds, fs_calls = phase_field_static()
    entries.append(sweep_entry("transport_sweep[C=7]", fs_calls,
                               fs_launches["sweep"], fs_rounds["sweep"]))
    del fs_calls
    log("where the time goes: one profiled 4096^2 field-static step")
    phase_breakdown(fs_sim)
    del fs_sim

    log("phase 9: noise 4096^2 on the card vs the CPU")
    phase_noise()

    log("phase 10: FP32 probe kernel vs plain chains, and the timed probe")
    probe = phase_probe()

    log("phase 11: headline bench 4096^2, --iters 32 and auto, --steps 8")
    _, probe_launches = phase_bench()
    entries.append(probe_entry(probe, probe_launches))

    log("phase 12: flagship example 1024^2, 32 steps")
    phase_example()

    log("phase 13: quality closure CohortClosure(nodes=4, colors=8)")
    phase_quality_erode_check()
    # The chunk rule reads the driver's free memory: hand back what the
    # earlier phases left in torch's cache.
    release_compiled()
    q_sim, _, q_launches, _, q_captured = phase_quality()
    log("where the time goes: one profiled 4096^2 quality step")
    phase_breakdown(q_sim)
    del q_sim
    release_compiled()
    entries.append(kernel_entry("fluvial", {"fluvial": q_captured},
                                q_launches, cohort.CohortClosure(nodes=4)))
    del q_captured

    log("phase 14: gradients through the kernels vs the plain path")
    phase_gradients()
    release_compiled()

    log("phase 15: multiscale cascade [(128^2, 2048), (256^2, 4), "
        "(1000^2, 4)]")
    cascade = phase_cascade()

    log("phase 16: trajectory golden 128^2 x 30 steps on the card")
    golden = phase_golden()

    log("phase 17: DEM examples (dem_process 1024^2, dem_condition 512^2, "
        "dem_multiflow 1024^2 K=512) and the TIFF examples")
    dem_ex = phase_dem_examples()

    # Each kernel's launches on the paths of phases 15-17, each path's
    # counts set to 0 just before it and read just after.
    by_name = {e["name"]: e for e in entries}
    for kind in ("fluvial", "debris"):
        by_name[f"cohort_round[{kind}]"]["launches_by_path"] = {
            "cascade": cascade["launches"][kind],
            "golden 128x30": golden["launches"][kind]}
    for kind in ("local", "trace"):
        by_name[f"tile_{kind}"]["launches_by_path"] = {
            name: dem_ex[name]["launches"][kind]
            for name in ("dem_process", "dem_condition", "dem_multiflow")}
        by_name[f"tile_{kind}"]["bitwise_at"] = sorted(dem_ex["ragged_tiles"])
    by_name["transport_sweep[C=1]"]["launches_by_path"] = {
        "dem_process": dem_ex["dem_process"]["launches"]["sweep"]}

    log("phase 18: closure variants of the cohort kernel")
    release_compiled()
    t18 = time.perf_counter()
    entries += phase_variants()
    log(f"  phase 18 took {time.perf_counter() - t18:.1f} s")

    release_compiled()
    t19 = time.perf_counter()
    log("phase 19: the Monte-Carlo particle path (transportMethod="
        "\"particles\"; dem_process --particles)")
    log(f"  (a) erosion step 4096^2, 16,777,216 particles, "
        f"{PARTICLE_MAXAGE - 1} rounds (cut from 511)")
    part_state, _ = phase_particles_full_width()
    log("  (b) the flagship configuration 256^2, 8192 particles, 255 "
        "rounds, 32 steps")
    flagship = phase_particles_flagship()
    log("  (b') the trajectory kernel against the plain loop at the "
        "flagship's size, both estimators, timed")
    for e in particle_kernel_entries():
        kind = e["name"][len("particle_rounds["):-1]
        e["launches_by_path"] = {
            "flagship 256^2, one ErosionSim.step (phase 19 (b))":
                flagship["launches"].get(kind, 0)}
        by_name[e["name"]] = e
        entries.append(e)
    log("  (c) dem_process --particles 1024^2 (1,048,576 particles, 2047 "
        "rounds)")
    dem_part = phase_dem_particles()
    for kind in ("local", "trace"):
        by_name[f"tile_{kind}"]["launches_by_path"][
            "dem_process --particles"] = dem_part["launches"][kind]
    log(f"  phase 19 took {time.perf_counter() - t19:.1f} s")

    t20 = time.perf_counter()
    log("phase 20: host utilities (checkpoint 4096^2, prefetch of 16 "
        "GeoTIFF tiles of 1024^2, the native library)")
    phase_checkpoint(part_state)
    del part_state
    release_compiled()
    phase_prefetch()
    phase_native()
    log(f"  phase 20 took {time.perf_counter() - t20:.1f} s")

    release_compiled()
    t21 = time.perf_counter()
    log("phase 21: sharded execution (soillib_tpu_torch.parallel), ranks "
        "spawned by parallel.launch")
    paths = phase_sharded(dem_keep)
    del dem_keep
    for path, counts in paths.items():
        for key, n in counts.items():
            name = {"tile_local": "tile_local", "tile_trace": "tile_trace",
                    "sweep": "transport_sweep[C=1]"}.get(
                        key, f"cohort_round[{key}]")
            by_name[name].setdefault("launches_by_path", {})[path] = n
    for name in ("cohort_round[fluvial]", "cohort_round[debris]",
                 "tile_local", "tile_trace", "transport_sweep[C=1]"):
        if not any(k.startswith(("sharded", "erosion_pod")) for k in
                   by_name[name].get("launches_by_path", {})):
            raise AssertionError(f"phase 21: {name} was not launched on a "
                                 f"sharded path: {paths}")
    log(f"  sharded launches by path {json.dumps(paths)}")
    log(f"  phase 21 took {time.perf_counter() - t21:.1f} s")

    release_compiled()
    t22 = time.perf_counter()
    log("phase 22: the compiled driver (one step captured as a CUDA graph, "
        "replayed) against the eager erode_step, configurations (a)-(g)")
    compiled = phase_compiled()
    for label, rec in compiled.items():
        if label == "state_copy_4096":
            continue
        path = f"compiled ({label}) {rec['what']}"
        for key, n in rec["compiled_launches"].items():
            by_name[f"cohort_round[{key}]"].setdefault(
                "launches_by_path", {})[path] = n
        if rec["compiled_sweep_launches"]:
            by_name["transport_sweep[C=7]"].setdefault(
                "launches_by_path", {})[path] = rec[
                    "compiled_sweep_launches"]["round"]
        for key, n in rec["compiled_particle_launches"].items():
            by_name[f"particle_rounds[{key}]"].setdefault(
                "launches_by_path", {})[path] = n
    log(f"  phase 22 took {time.perf_counter() - t22:.1f} s")

    release_compiled()
    t23 = time.perf_counter()
    log("phase 23: the transport-parity harness 256^2 (noise, steep; 4 "
        "seeds; cold, warm, 4 coupled steps x 2) and the age-deficit probe "
        "48^2")
    parity = phase_parity()
    for kind in ("fluvial", "debris"):
        by_name[f"cohort_round[{kind}]"].setdefault("launches_by_path", {})[
            "parity 256^2 (phase 23)"] = parity["launches"][kind]
    by_name["cohort_round[fluvial]"]["launches_by_path"][
        "age probe 48^2 (phase 23)"] = parity["probe_launches"]["fluvial"]
    log(f"  phase 23 took {time.perf_counter() - t23:.1f} s")

    release_compiled()
    t24 = time.perf_counter()
    log("phase 24: the weak-scaling harness, 1 and 4 ranks sharing the "
        "card (block 1024, 32 rounds)")
    scaled = phase_scaling()
    for kind in ("fluvial", "debris"):
        by_name[f"cohort_round[{kind}]"].setdefault("launches_by_path", {})[
            "scaling 2 x 2 sharing the card (phase 24)"] = scaled[kind]
    log(f"  phase 24 took {time.perf_counter() - t24:.1f} s")

    release_compiled()
    t25 = time.perf_counter()
    log("phase 25: the bench at 8192^2, albedo off, 32 rounds (the JAX "
        "headline's capacity configuration), and the ALBEDO=false cohort "
        "kernels on its inputs")
    entries += phase_headline_8192()[0]
    log(f"  phase 25 took {time.perf_counter() - t25:.1f} s")

    # The round bounds weigh exp, division and sqrt by the probe's costs.
    costs = probe["fp32"]["costs"]
    for e in entries:
        if e["name"].startswith("cohort_round"):
            cohort_bound(e, costs)
        elif e["name"].startswith("transport_sweep"):
            sweep_bound(e, costs)
        log(f"  {e['name']}: {e['ms']:.4f} ms against a bound of "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"{e['bound_ms'] / e['ms']:.0%} of it")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
