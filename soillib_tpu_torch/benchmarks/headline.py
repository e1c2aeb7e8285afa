"""The port's headline artifacts: the bench at the JAX headline's six
configurations (the file names and labels of `benchmarks/headline/`), each
run on the card in a fresh process, its stdout JSON line saved verbatim
with three added keys, as the JAX files carry them:

* `label`: the configuration, as the JAX file labels it;
* `ms_per_step`: W * H / value * 1000, rounded to 0.1 ms;
* `note`: the exact command that produced the line, and what to know
  when reading it.

    python -m soillib_tpu_torch.benchmarks.headline [--out DIR]
        [--record FILE]

writes DIR/<name>.json (default: this package's `headline/`, which
`results_table.py` renders into README.md) and a record of each run
(wall seconds, the bench's `[run]` line: peak device memory allocated
and reserved, kernel launches; its roofline line) to FILE. Then it runs
the flagship example (`python -m soillib_tpu_torch.examples.erosion
--steps 512`, 256^2) in a fresh process and records its wall time and
the ms per step of each report block. Every run is on the card; a run
that fails raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE = os.path.join(HERE, "headline")
RECORD = os.path.join(HERE, "records", "headline_runs.json")
BENCH = [sys.executable, "-m", "soillib_tpu_torch.bench"]
FLAGSHIP = [sys.executable, "-m", "soillib_tpu_torch.examples.erosion",
            "--steps", "512"]

YARDSTICK = ("bytes_per_cell_step is the port's fixed K=16 yardstick "
             "(soillib_tpu_torch/bench.py step_bytes_per_cell), not the "
             "TPU kernel's geometry at this size")
AUTO = ("transportTol=1e-6 (the adaptive exit); ceiling modeled at fixed "
        "510 rounds, so vs_baseline measures the adaptive win against a "
        "fixed-depth speed-of-light")

# name: (bench flags, label, note after the command). The names and
# labels are the JAX headline's (benchmarks/headline/*.json).
CONFIGS = {
    "0256_32": (["--size", "256"], "256² · 32 rounds",
                "the reference's erosion_gpu.py grid size"),
    "2048_32": (["--size", "2048"], "2048² · 32 rounds", ""),
    "4096_32": ([], "4096² · 32 rounds (headline)",
                "the bench's default"),
    "4096_auto": (["--iters", "auto"],
                  "4096² · auto(≤510) rounds (reference-faithful depth)",
                  AUTO),
    "8192_32": (["--size", "8192", "--albedo", "off"],
                "8192² · 32 rounds · albedo off",
                f"{YARDSTICK} (1200 here; the JAX file's 1744)"),
    "8192_auto": (["--size", "8192", "--albedo", "off", "--iters", "auto"],
                  "8192² · auto(≤510) rounds · albedo off",
                  f"{AUTO}; {YARDSTICK} (16800 here; the JAX file's "
                  f"25504)"),
}


def command(name: str) -> str:
    """The shell command of configuration `name`."""
    return " ".join(["python -m soillib_tpu_torch.bench", *CONFIGS[name][0]])


def config_of(name: str) -> dict:
    """{size, iters, albedo} of configuration `name` (the bench's
    defaults where its flags are silent: 4096, 32, on)."""
    flags = dict(zip(CONFIGS[name][0][::2], CONFIGS[name][0][1::2]))
    return {"size": int(flags.get("--size", 4096)),
            "iters": flags.get("--iters", "32"),
            "albedo": flags.get("--albedo", "on") == "on"}


def headline_line(name: str, line: dict) -> dict:
    """The bench's JSON line `line` with the three added keys."""
    _, label, note = CONFIGS[name]
    size = config_of(name)["size"]
    return {**line, "label": label,
            "ms_per_step": round(size * size / line["value"] * 1e3, 1),
            "note": command(name) + (f"; {note}" if note else "")}


def run_bench(name: str) -> tuple:
    """Configuration `name` in a fresh process: (its JSON line, the run's
    record)."""
    t0 = time.perf_counter()
    r = subprocess.run(BENCH + CONFIGS[name][0], capture_output=True,
                       text=True)
    seconds = time.perf_counter() - t0
    if r.returncode:
        raise RuntimeError(f"{command(name)} exited {r.returncode}:\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    err = r.stderr.splitlines()
    run = next(s for s in err if s.startswith("[run] "))
    m = re.search(r"allocated ([\d.]+) GB, reserved ([\d.]+) GB", run)
    rec = {"command": command(name), "seconds": seconds,
           "peak_allocated_gb": float(m[1]), "peak_reserved_gb": float(m[2]),
           "launches": json.loads(run.split("launches ", 1)[1]),
           "roofline": next(s for s in err if s.startswith("[roofline]")),
           "device": line["device"]}
    return line, rec


def run_flagship() -> dict:
    """The flagship example in a fresh process: wall seconds, each report
    block's ms per step, and the card."""
    import torch

    from soillib_tpu_torch.bench import smi_query

    t0 = time.perf_counter()
    r = subprocess.run(FLAGSHIP, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode:
        raise RuntimeError(f"the flagship example exited {r.returncode}:\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    blocks = [float(m[1]) for m in
              re.finditer(r"steps +\d+/\d+: ([\d.]+) ms/step", r.stdout)]
    return {"command": " ".join(["python", *FLAGSHIP[1:]]),
            "seconds": seconds, "block_ms_per_step": blocks,
            "device": smi_query("name,power.limit", torch.device("cuda", 0))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.benchmarks.headline")
    ap.add_argument("--out", default=HEADLINE,
                    help="directory of the <name>.json files")
    ap.add_argument("--record", default=RECORD,
                    help="JSON record of the runs")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    record = {"runs": {}}
    for name in CONFIGS:
        line, rec = run_bench(name)
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(headline_line(name, line), f, indent=1)
            f.write("\n")
        record["runs"][name] = rec
        print(f"{name}: {json.dumps(line)}\n  {json.dumps(rec)}",
              flush=True)
    record["flagship"] = run_flagship()
    print(f"flagship: {json.dumps(record['flagship'])}", flush=True)
    with open(args.record, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return record


if __name__ == "__main__":
    main()
