"""The per-layer metrics' arithmetic on a traced run's record (see
`run.run_cell`): the device operations as (name, start s, end s, kind),
the profiled steps, the program's counter changes over them, and the
unprofiled window's host ms a step. Each metric's own reader,
`metrics/<name>.py`, is one of these. A reader that finds nothing to read
returns None."""

from __future__ import annotations

from perfbench import yardstick
from perfbench.trace import is_cohort, is_particle


def kernels_per_step(rec):
    """Device kernels in the profiled steps over the steps (copies and
    fills not counted)."""
    n = sum(1 for *_, kind in rec["device_ops"] if kind == "kernel")
    return n / rec["steps"] if n else None


def host_ms_per_step(rec):
    """The host clock around each call of the program's `step()`, no
    synchronise inside, averaged: the smaller of the unprofiled window's
    calls (which wait for room in the launch queue once the window's
    run-ahead fills it) and the warm-up's calls after the captures (each
    on an idle device)."""
    return rec.get("host_ms_per_step")


def cohort_roofline_pct(rec):
    """100 * bound / the cohort round kernels' device time over the
    profiled steps. The bound is, per rule set, the larger of the
    reference round's weighted operations over the FP32 rate and the
    K = 16 byte model over the HBM rate, times the cells, times the rounds
    that ran (the program's `cohort_rounds` counter over the same steps,
    which counts on the device up to the adaptive exit)."""
    t = sum(e - s for name, s, e, _ in rec["device_ops"] if is_cohort(name))
    rounds = rec["counters"].get("cohort_rounds", {})
    if t <= 0.0 or not rounds:
        return None
    bound = 0.0
    for key, n in rounds.items():
        if key not in ("fluvial", "debris"):
            return None  # another closure's kernel: not in this yardstick
        bound += n * yardstick.round_bound_s(key, rec["albedo"],
                                             rec["cells"])
    return 100.0 * bound / t


def glue_ms_per_step(rec):
    """Device ms a step of every device operation that is not a cohort
    round: the model glue (gradients, sources, normalisation, blend,
    transfer, creep) and the step's copies."""
    ops = rec["device_ops"]
    if not ops:
        return None
    t = sum(e - s for name, s, e, _ in ops if not is_cohort(name))
    return t * 1e3 / rec["steps"]


def particle_roofline_pct(rec):
    """100 * bound / the particle kernels' device time over the profiled
    steps. The bound is the bytes of the live particle-rounds that ran
    (the program's `particle_rounds` counter over the same steps, by
    estimator), at the plain round's bytes a live particle-round
    (`yardstick.particle_round_bytes`), over the HBM rate."""
    t = sum(e - s for name, s, e, _ in rec["device_ops"]
            if is_particle(name))
    rounds = rec["counters"].get("particle_rounds", {})
    if t <= 0.0 or not rounds:
        return None
    bound = 0.0
    for kind, n in rounds.items():
        if kind not in yardstick.PARTICLE_FIELDS:
            return None  # another estimator: not in this yardstick
        bound += n * yardstick.particle_round_bytes(kind)
    return 100.0 * bound / yardstick.HBM_BYTES_PER_S / t
