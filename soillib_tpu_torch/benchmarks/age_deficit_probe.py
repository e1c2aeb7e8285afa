"""Per-age deposit totals, field cohort vs MC, single-origin patch
(counterpart of `benchmarks/age_deficit_probe.py`): where does the
single-origin flux deficit arise?

The field side runs the fluvial cohort solve of `transport_fluvial` round
by round and records each round's water deposit total. On the card each
round is one launch of the cohort kernel (`ops/cohort.py`
`cohort_round_cuda`), so the trace is the kernel's; on the CPU each is
the plain `cohort_round`. The MC side averages the particle estimator's
discharge totals over 6 seeds at each maxage and the two are compared at
matching deposit depths (maxage - 2 rounds).

    python -m soillib_tpu_torch.benchmarks.age_deficit_probe [--size 48]
        [--cpu] [--out FILE]

Prints the JAX probe's four lines (`--out` writes them as JSON, with the
per-round trace and the device it ran on).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch.benchmarks import parity
from soillib_tpu_torch.benchmarks.residual_probe import (
    SCALE,
    patch_rain,
    warm_state,
)
from soillib_tpu_torch.core.device import _device, seeded_generator
from soillib_tpu_torch.models import erosion as ero
from soillib_tpu_torch.ops import cohort as co

AGES = (4, 8, 16, 32, 64, 128)
ROUNDS = 126
MC_SEEDS = 6


def field_trace(st, rain, scale, p, rounds=ROUNDS, plain=False):
    """(per-round water deposit totals (rounds,) float32 numpy, final
    deposits G) of the fluvial cohort solve of `st` with source `rain`,
    built as `models/erosion.py` `_fluvial_cohort` builds it. On the card
    every round is one launch of the cohort kernel unless `plain`; the
    totals stay on the device until the last round."""
    t = ero._fluvial_terms(st.layers, rain, st.discharge, st.momentum,
                           st.albedo_surface, scale, p)
    speed, Llen, A = t["speed"], t["Llen"], t["A"]
    accel = t["E_v"] / A + t["force"][:, None, None]
    rules = ero.make_fluvial_rules(p, Llen)
    W, H = st.discharge.shape
    bd = ero._birth_density(W, H, device=st.discharge.device)
    carried0 = [bd * t["E_w"], bd * t["E_m"], bd * t["E_v"][0],
                bd * t["E_v"][1]]
    if t["E_a"] is not None:
        carried0 += [bd * t["E_a"][0], bd * t["E_a"][1], bd * t["E_a"][2]]
    fD = p.frictionFactor / 8.0
    rate_v = torch.clamp(ero._sdiv(-Llen * 0.125 * fD, ero._EPS + st.discharge),
                         -ero._RATE_CLIP, 0.0)
    aux = (accel[0], accel[1], torch.ones_like(st.discharge), rate_v)
    sA = co.as_stack(ero._build_cohort_state(bd, speed, carried0,
                                             None)).contiguous()
    auxs = co.as_stack(aux).contiguous()
    C = co.n_deposits(sA.shape[0])
    G = torch.zeros((C, W, H), device=sA.device)
    kernel = sA.device.type == "cuda" and not plain
    per_round = []
    for _ in range(rounds):
        w0 = G[0].clone()
        if kernel:
            sA = co.cohort_round_cuda(sA, auxs, G, rules, Llen)
        else:
            sA, G = co.cohort_round(sA, G, auxs, rules, Llen)
        per_round.append((G[0] - w0).sum())
    return torch.stack(per_round).cpu().numpy(), G


def mc_total(st, rain, maxage, seed, nsamples):
    """Total of the particle estimator's discharge at `maxage`."""
    pm = soil.param_t()
    pm.maxage = maxage
    pm.timeStep = 500.0
    pm.nSamples = nsamples
    F = soil.transport_fluvial(
        st.layers, rain, st.discharge, st.mass, st.momentum,
        st.albedo_surface, SCALE, pm, method="particles",
        key=seeded_generator(st.discharge.device, seed))[0]
    # transport_fluvial normalizes both paths alike, so the normalized
    # outputs' totals compare.
    return float(F.sum())


def run(size=48, device="cuda"):
    """The probe's totals: the field's cumulative water flux, the MC
    discharge totals by maxage (mean of MC_SEEDS seeds), the field's
    totals at the matching depths, their ratio, and the per-round trace."""
    dev = _device(device)
    st = warm_state(size, dev)
    rain = patch_rain(size, dev)
    p = soil.param_t()
    p.maxage = 128
    p.timeStep = 500.0
    per_round, G = field_trace(st, rain, SCALE, p)

    nsamples = size * size * 64
    mc_tot = {a: float(np.mean([mc_total(st, rain, a, s, nsamples)
                                for s in range(MC_SEEDS)])) for a in AGES}
    cum = np.cumsum(per_round)
    # convert field flux to discharge-output totals like transport_fluvial:
    norm = float(SCALE[1])
    A = SCALE[0] * SCALE[1]
    rain_term = float((A * p.rainfall * rain).sum())
    fld_tot = {a: (rain_term + float(cum[a - 2 - 1])) / norm for a in AGES}
    return {
        "field_cumulative_w_flux": float(G[0].sum()),
        "mc_totals_by_maxage": mc_tot,
        "field_totals_by_depth": fld_tot,
        "ratio_by_depth": {a: fld_tot[a] / mc_tot[a] for a in AGES},
        "field_per_round": [float(v) for v in per_round],
        "config": f"single 4x4-patch rain on warmed {size}^2 noise terrain; "
                  f"water discharge totals, {MC_SEEDS}-seed MC mean",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.benchmarks.age_deficit_probe")
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    out = run(args.size, device)
    print("field cumulative W-flux:", round(out["field_cumulative_w_flux"], 3))
    for key, name, digits in (
            ("mc_totals_by_maxage", "MC totals by maxage:", 2),
            ("field_totals_by_depth", "field totals by depth:", 2),
            ("ratio_by_depth", "ratio by depth:", 4)):
        print(name, {a: round(v, digits) for a, v in out[key].items()})
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(out, device=parity.device_line(device)), fh,
                      indent=1)
    return out


if __name__ == "__main__":
    main()
