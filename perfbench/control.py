"""The readings the limits are set from, at a cell's own size on the card:

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3
        [--picks all|first|extra] [--control-seeds 1]
        [--out chiprun_out/<file>.json]

For each seed the program runs the cell's steps as a run does (its
warm-up steps, then the window's), up to the steps a run with that seed
checks (`run.checked_steps`; `--picks first`: the first alone;
`--picks extra`: the pipeline's first step checked after the window, for
erosion the albedo step, here right after the warm-up), keeping each
checked step's input and output. Then, the program freed, the plain
reference runs each checked step from the same input, and so does the
pipeline's control (for the `--control-seeds`, by default every seed): the
reference in the nearest precision below the configuration's (erosion:
bfloat16 for float32), put in the program's place. The program's gaps
against the reference are lower readings; the control's are upper
readings. Each gap is recorded (the pipeline's `gaps`); the numbers
compared are the pipeline's `numbers` of them. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def readings(cell: dict, seed: int, picks: str, control: bool = True,
             device="cuda") -> dict:
    import torch

    from perfbench import run, spec

    cfg = spec.config(cell["config"])
    trf = spec.traffic(cell["traffic"])
    dev = torch.device(device)
    pipe = spec.pipeline(spec.pipeline_name(cfg)).Pipeline(
        cfg, trf, seed, dev)
    first, window_picks = run.checked_steps(trf, seed)
    warm = run.WARMUP_STEPS
    steps = [0] * first + [warm + j for j in window_picks]
    if picks == "first":
        steps = steps[:1]
    elif picks == "extra":
        steps = [warm]
    prog = pipe.setup(pipe.inputs())
    kept = {}
    for i in range(max(steps) + 1):
        if picks == "extra" and i == warm:
            prog.load(pipe.extra_inputs(prog.state())[0])
        if i in steps:
            kept[i] = {"in": {k: v.to("cpu")
                              for k, v in prog.state().items()}}
        prog.step()
        if i in steps:
            kept[i]["out"] = {k: v.to("cpu")
                              for k, v in prog.state().items()}
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {}
    for i in steps:
        inp = {k: v.to(dev) for k, v in kept[i]["in"].items()}
        res = {k: v.to(dev) for k, v in kept[i]["out"].items()}
        t0 = time.time()
        ref = pipe.reference(inp, i)
        t_ref = time.time() - t0
        out[i] = {"program": pipe.gaps(inp, res, ref), "reference_s": t_ref}
        if control:
            ctrl = pipe.control(inp, i)
            out[i]["control"] = pipe.gaps(inp, ctrl, ref)
            del ctrl
        del inp, res, ref
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--picks", choices=("all", "first", "extra"),
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
