"""Transport parity study: converged particle-MC oracle vs the field solve
(counterpart of `benchmarks/parity.py`).

The port's particle methods (`models/erosion.py` `_fluvial_particles` /
`_debris_particles`, `ops/transport.py` `_solve_particles`) are faithful
ports of the reference MC kernels (erosion.cu:29-141, 245-351); averaged
over enough particles and seeds they ARE the reference model's
expectation. This harness measures how closely the deterministic field
solve tracks that expectation -- per output field, per terrain, cold and
warm start, single-phase and multi-step coupled -- and reports the MC
split-half noise floor alongside so signal and noise are separable.

The field half goes through the port's entry points: on the card every
fluvial and debris solve is launches of the cohort kernel, and the
coupled runs go through `erode` (one step captured as a CUDA graph per
parameter set and shape, shared by the repetitions). The particle
births draw from `torch.Generator`s seeded as `seeded_generator(device,
seed)` where the JAX harness takes `PRNGKey(seed)`: the same seeds, other
numbers. Metrics are float64 numpy on the host, one copy per output.

Usage:
  python -m soillib_tpu_torch.benchmarks.parity --size 48 --seeds 32 \
      --out parity.json
  python -m soillib_tpu_torch.benchmarks.parity --quick --cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch.core.device import _device, seeded_generator

CROP = 4  # interior margin excluded from metrics (boundary effects)

TERRAINS = ("ramp", "noise", "conditioned", "steep")
FLUVIAL_FIELDS = ("discharge", "mass", "momentum", "albedo")
DEBRIS_FIELDS = ("mass", "momentum", "albedo")
COUPLED_FIELDS = ("height", "discharge", "mass", "momentum", "debris")
METRIC_KEYS = ("rel_mean", "corr", "nrmse", "mc_selfcorr")
COUPLED_KEYS = ("field_vs_mc_relmean", "field_vs_mc_corr",
                "mc_vs_mc_relmean", "mc_vs_mc_corr")
CONFIG_KEYS = ("size", "seeds", "maxage", "steps", "nodes", "colors")


# ---------------------------------------------------------------------------
# Terrains
# ---------------------------------------------------------------------------


def make_terrains(size, which=TERRAINS, device="cuda"):
    """{name: (W, H) float32 tensor on `device`}, in TERRAINS order: the
    JAX harness's terrains, bit for bit."""
    dev = _device(device)
    W = H = size
    out = {}
    if "ramp" in which:
        # Smooth ramp with a mild cross-slope so the upwind split exercises
        # both axes (a pure-axis ramp hides direction errors). Made on the
        # host with the JAX harness's numpy calls.
        x = np.linspace(1.0, 0.0, W, dtype=np.float32)[:, None]
        y = np.linspace(0.15, 0.0, H, dtype=np.float32)[None, :]
        out["ramp"] = torch.from_numpy(
            np.broadcast_to(x + y, (W, H)).astype(np.float32)).to(dev)
    if "noise" in which:
        h = soil.noise((W, H), soil.noise_t(seed=3.0), device=dev)
        out["noise"] = 0.5 * h + 1.0
    if "conditioned" in which:
        h = soil.noise((W, H), soil.noise_t(seed=7.0), device=dev)
        out["conditioned"] = soil.fill_depressions(0.5 * h + 1.0)
    if "steep" in which:
        # Amplified relief + ramp so slopes clear critSlopeBedrock and the
        # debris phase has structured spatial signal.
        h = soil.noise((W, H), soil.noise_t(seed=11.0), device=dev)
        x = torch.from_numpy(
            np.linspace(1.5, 0.0, W, dtype=np.float32)[:, None]).to(dev)
        out["steep"] = 1.5 * h + x + 2.0
    return out


def make_state(terrain, warm_steps, scale, param, seed=0):
    """Cold state (zeros) or a warm state advanced by `warm_steps` field
    steps -- warm matters because discharge/momentum feed the attenuation
    and source terms of the next transport phase."""
    state = soil.ErosionState.zeros(terrain.shape, height=terrain,
                                    device=terrain.device)
    if warm_steps:
        state = soil.erode(state, scale, param, steps=warm_steps,
                           key=seeded_generator(terrain.device, seed))
    return state


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _host(a):
    """float64 numpy copy of a tensor (one copy from the device) or array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _flat(a):
    a = _host(a)
    if a.ndim == 3:  # channel-first: crop spatial dims
        return a[:, CROP:-CROP, CROP:-CROP].reshape(-1)
    return a[CROP:-CROP, CROP:-CROP].reshape(-1)


def metrics(field_val, mc_val):
    """Relative mean error, Pearson correlation, normalized RMSE."""
    a, b = _flat(field_val), _flat(mc_val)
    mb = float(np.abs(b).mean())
    denom = mb if mb > 0 else 1.0
    rel_mean = float(abs(a.mean() - b.mean()) / denom)
    if a.std() == 0 or b.std() == 0:
        corr = 1.0 if np.allclose(a, b) else 0.0
    else:
        corr = float(np.corrcoef(a, b)[0, 1])
    nrmse = float(np.sqrt(((a - b) ** 2).mean()) / denom)
    return {"rel_mean": rel_mean, "corr": corr, "nrmse": nrmse}


def mc_average(fn, n_seeds, base_seed=0, device="cuda"):
    """Average `fn(generator) -> tuple of tensors` over seeds, each call
    given `seeded_generator(device, base_seed + 1000 + s)`; returns (mean,
    half_a, half_b) so split-half self-correlation bounds the MC noise
    floor. The halves are summed on the device."""
    acc_a = acc_b = None
    for s in range(n_seeds):
        out = tuple(fn(seeded_generator(device, base_seed + 1000 + s)))
        if s % 2 == 0:
            acc_a = out if acc_a is None else tuple(
                a + o for a, o in zip(acc_a, out))
        else:
            acc_b = out if acc_b is None else tuple(
                b + o for b, o in zip(acc_b, out))
    na, nb = (n_seeds + 1) // 2, n_seeds // 2
    half_a = tuple(x / na for x in acc_a)
    half_b = tuple(x / nb for x in acc_b) if nb else half_a
    mean = tuple((a * na + b * nb) / (na + nb)
                 for a, b in zip(half_a, half_b))
    return mean, half_a, half_b


# ---------------------------------------------------------------------------
# Single-phase comparisons
# ---------------------------------------------------------------------------


def _phase_report(names, f, mc, ha, hb, mass_idx):
    """Per-field metrics; the albedo ratio field is compared mass-weighted
    -- the raw transported-albedo ratio G_a/G_m is degenerate wherever the
    mass flux is trace-level (the reference applies no floor either,
    erosion.cu:181-186), so cells below 1% of the mean MC mass carry no
    signal and are weighted out."""
    f, mc, ha, hb = ([_host(x) for x in t] for t in (f, mc, ha, hb))
    rep = {}
    for i, name in enumerate(names):
        if name == "albedo":
            # Weight by the LESSER of the two mass fields: the ratio is
            # only meaningful where both methods actually carry mass.
            wgt = np.minimum(np.maximum(mc[mass_idx], 0.0),
                             np.maximum(f[mass_idx], 0.0))
            thr = 0.01 * wgt.mean() if wgt.mean() > 0 else 0.0
            wgt = np.where(wgt > thr, wgt, 0.0)[None]
            rep[name] = metrics(f[i] * wgt, mc[i] * wgt)
            rep[name]["mc_selfcorr"] = metrics(ha[i] * wgt,
                                               hb[i] * wgt)["corr"]
        else:
            rep[name] = metrics(f[i], mc[i])
            rep[name]["mc_selfcorr"] = metrics(ha[i], hb[i])["corr"]
    return rep


def compare_fluvial(state, scale, param, n_seeds):
    args = (state.layers, state.rainfall, state.discharge, state.mass,
            state.momentum, state.albedo_surface, scale)

    f = soil.transport_fluvial(*args, param, method="field")
    mc, ha, hb = mc_average(
        lambda g: soil.transport_fluvial(*args, param, method="particles",
                                         key=g),
        n_seeds, device=state.device,
    )
    return _phase_report(FLUVIAL_FIELDS, f, mc, ha, hb, mass_idx=1)


def compare_debris(state, scale, param, n_seeds):
    args = (state.layers, state.debris, state.debris_momentum,
            state.albedo_surface, scale)

    f = soil.transport_debris(*args, param, method="field")
    mc, ha, hb = mc_average(
        lambda g: soil.transport_debris(*args, param, method="particles",
                                        key=g),
        n_seeds, device=state.device,
    )
    return _phase_report(DEBRIS_FIELDS, f, mc, ha, hb, mass_idx=0)


# ---------------------------------------------------------------------------
# Multi-step coupled trajectories
# ---------------------------------------------------------------------------


def compare_coupled(terrain, scale, param, steps, n_rep=3):
    """Field-stepped vs particle-stepped coupled trajectories.

    The particle runs use distinct master seeds; their pairwise spread is
    the stochastic reference band the field trajectory must sit inside.
    Compared on the prognostic fields after `steps` coupled steps."""
    dev = terrain.device
    pf = param.replace(transportMethod="field")
    pp = param.replace(transportMethod="particles")

    sf = make_state(terrain, 0, scale, pf)
    f_out = soil.erode(sf, scale, pf, steps=steps,
                       key=seeded_generator(dev, 0))

    p_outs = []
    for r in range(n_rep):
        sp = make_state(terrain, 0, scale, pp)
        p_outs.append(soil.erode(sp, scale, pp, steps=steps,
                                 key=seeded_generator(dev, 100 + r)))

    rep = {}
    for name in COUPLED_FIELDS:
        f_val = _host(getattr(f_out, name))
        p_vals = [_host(getattr(po, name)) for po in p_outs]
        vs_mc = [metrics(f_val, pv) for pv in p_vals]
        mc_spread = [
            metrics(p_vals[i], p_vals[j])
            for i in range(n_rep) for j in range(i + 1, n_rep)
        ]
        rep[name] = {
            "field_vs_mc_relmean": float(np.mean([m["rel_mean"] for m in vs_mc])),
            "field_vs_mc_corr": float(np.mean([m["corr"] for m in vs_mc])),
            "mc_vs_mc_relmean": float(np.mean([m["rel_mean"] for m in mc_spread])),
            "mc_vs_mc_corr": float(np.mean([m["corr"] for m in mc_spread])),
        }
    return rep


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------


def key_paths(tree, prefix=()):
    """The set of key paths to the leaves of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix}
    out = set()
    for k, v in tree.items():
        out |= key_paths(v, prefix + (k,))
    return out


def report_skeleton(terrains, coupled=True):
    """A report of `run` with every value None: the JAX harness's keys
    for these terrains."""
    m = dict.fromkeys(METRIC_KEYS)
    sk = {"config": dict.fromkeys(CONFIG_KEYS), "nsamples": None}
    for t in terrains:
        sk[t] = {regime: {"fluvial": {f: m for f in FLUVIAL_FIELDS},
                          "debris": {f: m for f in DEBRIS_FIELDS}}
                 for regime in ("cold", "warm")}
        if coupled:
            sk[t]["coupled"] = {f: dict.fromkeys(COUPLED_KEYS)
                                for f in COUPLED_FIELDS}
    return sk


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.benchmarks.parity")
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--nsamples", type=int, default=0,
                    help="particles per seed (default W*H*16)")
    ap.add_argument("--maxage", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20, help="coupled steps")
    ap.add_argument("--coupled-nsamples", type=int, default=0,
                    help="particles per coupled step (default W*H*64)")
    ap.add_argument("--terrains", default=",".join(TERRAINS))
    ap.add_argument("--nodes", type=int, default=1,
                    help="face-routed mixture nodes (quality mode; "
                         "CohortClosure.nodes)")
    ap.add_argument("--colors", type=int, default=1,
                    help="colored birth sub-ensembles (quality mode; "
                         "CohortClosure.colors)")
    ap.add_argument("--color-rule", default="hash", choices=("hash", "dir"))
    ap.add_argument("--skip-coupled", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.quick:
        args.seeds, args.steps = 8, 8
        args.terrains = "ramp"
    return args


def run(args, n_rep=3, log=print):
    """The study of `parse_args`'s `args`: the report (the JAX harness's
    keys), its lines passed to `log`. `n_rep` particle trajectories per
    coupled comparison."""
    device = _device("cpu" if args.cpu else "cuda")
    scale = (0.078, 0.078, 4.0)
    size = args.size
    param = soil.ErosionParams()
    param.maxage = args.maxage
    # Field rounds == particle deposit opportunities: the MC loop runs
    # maxage-1 iterations, the first of which never deposits (the particle
    # is still inside its birth cell), so maxage-2 transit deposits.
    param.transportIterations = args.maxage - 2
    param.nSamples = args.nsamples or size * size * 16
    param.timeStep = 500.0  # visible terrain change within few steps
    if args.nodes > 1 or args.colors > 1:
        param.closure = soil.CohortClosure(nodes=args.nodes,
                                           colors=args.colors,
                                           color_rule=args.color_rule)

    terrains = make_terrains(size, tuple(args.terrains.split(",")), device)
    report = {"config": {k: getattr(args, k) for k in CONFIG_KEYS},
              "nsamples": param.nSamples}

    for tname, terr in terrains.items():
        report[tname] = {}
        for regime, warm in (("cold", 0), ("warm", 8)):
            st = make_state(terr, warm, scale, param)
            rep_f = compare_fluvial(st, scale, param, args.seeds)
            rep_d = compare_debris(st, scale, param, args.seeds)
            report[tname][regime] = {"fluvial": rep_f, "debris": rep_d}
            log(f"== {tname}/{regime} ==")
            for phase, rep in (("fluvial", rep_f), ("debris", rep_d)):
                for fld, m in rep.items():
                    log(f"  {phase:8s} {fld:9s} rel_mean={m['rel_mean']:.4f} "
                        f"corr={m['corr']:.4f} nrmse={m['nrmse']:.4f} "
                        f"(mc self-corr {m['mc_selfcorr']:.4f})")

    if not args.skip_coupled:
        pc = param.replace(
            nSamples=args.coupled_nsamples or size * size * 64
        )
        for tname, terr in terrains.items():
            rep = compare_coupled(terr, scale, pc, args.steps, n_rep)
            report[tname]["coupled"] = rep
            log(f"== {tname}/coupled x{args.steps} ==")
            for fld, m in rep.items():
                log(f"  {fld:9s} field-vs-mc rel={m['field_vs_mc_relmean']:.4f} "
                    f"corr={m['field_vs_mc_corr']:.4f} | mc-vs-mc "
                    f"rel={m['mc_vs_mc_relmean']:.4f} corr={m['mc_vs_mc_corr']:.4f}")
    return report


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    from soillib_tpu_torch.bench import smi_query

    return smi_query("name,power.limit", dev)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    report = run(args)
    if args.out:
        # Beyond the JAX harness's keys, the record says where it ran, how
        # long it took and the card's peak memory.
        with open(args.out, "w") as fh:
            json.dump(dict(report, device=device_line(device),
                           seconds=time.perf_counter() - t0,
                           peak_memory_gb=(
                               torch.cuda.max_memory_allocated(device) / 1e9
                               if device.type == "cuda" else None)),
                      fh, indent=1)
        print("wrote", args.out)
    return report


if __name__ == "__main__":
    main()
