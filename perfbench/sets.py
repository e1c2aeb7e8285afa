"""Runs of one cell in a row, each a fresh process, and the spread of each
metric over them: how the bounds in BENCHMARK.json were measured.

    python3 -m perfbench.sets --workload <cell> --seeds 11,12,13
        [--seconds 30] [--trace 0] [--out chiprun_out/<file>.json]

Each run is `python3 -m perfbench.run` with one seed; their result lines,
the end of each one's stderr, and per metric the median, the quartiles
(statistics.quantiles, n=4) and the spread (the distance between the
quartiles over the median) go to `--out` and, in short, to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values) -> dict:
    med = statistics.median(values)
    if len(values) < 2:
        return {"median": med, "n": len(values)}
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": med, "q1": q1, "q3": q3, "n": len(values),
            "spread": (q3 - q1) / med if med else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.sets")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench import spec

    seconds = args.seconds or spec.benchmark()["run_seconds"]
    runs = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        p = subprocess.run(
            [sys.executable, "-m", "perfbench.run", "--workload",
             args.workload, "--seed", str(seed), "--seconds", str(seconds),
             "--trace", str(args.trace)], capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            line = None
        runs.append({"seed": seed, "rc": p.returncode,
                     "wall_s": time.time() - t0, "line": line,
                     "stderr_tail": p.stderr[-3000:]})
        m = line["metrics"] if line else {}
        print(f"{args.workload} seed {seed} rc {p.returncode} correct "
              f"{line and line['correct']} "
              + " ".join(f"{k}={v['value']:.6g}" for k, v in m.items()),
              flush=True)
        if not line:
            print(p.stderr[-3000:], flush=True)
    names = sorted({k for r in runs if r["line"]
                    for k in r["line"]["metrics"]})
    summary = {k: spread([r["line"]["metrics"][k]["value"] for r in runs
                          if r["line"] and k in r["line"]["metrics"]])
               for k in names}
    for k, s in summary.items():
        print(f"  {k}: {json.dumps(s)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seconds": seconds,
                       "trace": args.trace, "runs": runs,
                       "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
