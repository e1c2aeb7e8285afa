"""The readings the limits are set from, at a cell's own size on the card:

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3
        [--picks all|first|albedo] [--control-seeds 1]
        [--out chiprun_out/<file>.json]

For each seed the program runs the cell's steps as a run does (its
warm-up steps, then the window's), up to the steps a run with that seed
checks (`run.checked_steps`; `--picks first`: the first alone;
`--picks albedo`: the albedo step alone, here right after the warm-up),
keeping each checked step's input and output. Then, the program freed, the
plain reference runs each checked step from the same
input in float32, and again in bfloat16 (for the `--control-seeds`, by default every seed), the
nearest precision below the configuration's float32 (the step has no matrix product, so TF32 would
change nothing): the control, put in the program's place. The program's
numbers against the float32 reference are lower readings; the control's
are upper readings. Each field's gap is recorded (`check.fields`); the
numbers compared are their groups (`check.GROUPS`). The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def control_step(inp: dict, scale, p: dict, generator=None,
                 dtype=None) -> dict:
    """The reference's step computed in `dtype` (bfloat16 by default),
    returned in float32."""
    import torch

    from perfbench.reference import step as reference

    dtype = dtype or torch.bfloat16
    low = {k: v.to(dtype) for k, v in inp.items()}
    out = reference.erode_step(low, scale, p, generator)
    return {k: v.to(torch.float32) for k, v in out.items()}


def readings(cell: dict, seed: int, picks: str, control: bool = True,
             device="cuda") -> dict:
    import torch

    import soillib_tpu_torch as soil
    from perfbench import check, run, spec, terrain
    from perfbench.reference import rng, step as reference

    cfg = spec.config(cell["config"])
    trf = spec.traffic(cell["traffic"])
    p = spec.params(cfg, trf)
    W, H = cfg["grid"]
    scale = tuple(float(s) for s in cfg["scale"])
    dev = torch.device(device)
    first, window_picks = run.checked_steps(trf, seed)
    warm = run.WARMUP_STEPS
    steps = [0] * first + [warm + j for j in window_picks]
    if picks == "first":
        steps = steps[:1]
    elif picks == "albedo":
        steps = [warm]
    sim = soil.ErosionSim((W, H), scale, run.program_params(soil, p),
                          state=soil.ErosionState(
                              **run.make_fields(cfg, trf, seed, dev)),
                          seed=terrain.sim_seed(seed), device=dev)
    kept = {}
    for i in range(max(steps) + 1):
        if picks == "albedo" and i == warm:
            sim.state = soil.ErosionState(**run.with_drawn_albedos(
                {f: getattr(sim.state, f) for f in reference.FIELDS}, seed))
        if i in steps:
            kept[i] = {"in": {f: getattr(sim.state, f).to("cpu")
                              for f in reference.FIELDS}}
        sim.step()
        if i in steps:
            kept[i]["out"] = {f: getattr(sim.state, f).to("cpu")
                              for f in reference.FIELDS}
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for i in steps:
        inp = {k: v.to(dev) for k, v in kept[i]["in"].items()}
        prog = {k: v.to(dev) for k, v in kept[i]["out"].items()}

        def gen():
            if p["transportMethod"] != "particles":
                return None
            g = rng.generator(dev, terrain.sim_seed(seed))
            reference.skip_births(int(p["nSamples"]), g, dev, i)
            return g

        t0 = time.time()
        ref = reference.erode_step(inp, scale, p, gen())
        t_ref = time.time() - t0
        out[i] = {"program": check.fields(inp, prog, ref),
                  "reference_s": t_ref}
        if control:
            ctrl = control_step(inp, scale, p, gen())
            out[i]["control"] = check.fields(inp, ctrl, ref)
            del ctrl
        del inp, prog, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--picks", choices=("all", "first", "albedo"),
                    default="all")
    ap.add_argument("--control-seeds", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from perfbench import spec

    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(spec.benchmark(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controlled = (seeds if args.control_seeds is None else
                  [int(s) for s in args.control_seeds.split(",")])
    res = {}
    for seed in seeds:
        res[seed] = readings(cell, seed, args.picks, seed in controlled)
        for i, r in res[seed].items():
            print(f"{args.workload} seed {seed} step {i} ref "
                  f"{r['reference_s']:.1f} s", flush=True)
            for k in r["program"]:
                ctrl = r.get("control", {}).get(k)
                print(f"  {k}: program {r['program'][k]:.3e} control "
                      + ("-" if ctrl is None else f"{ctrl:.3e}"),
                      flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "readings": res}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
