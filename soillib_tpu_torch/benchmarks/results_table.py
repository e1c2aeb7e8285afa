"""One source of truth for the port's headline table in README.md (the
twin of `tools/results_table.py`): the table between the PORT-BENCH-TABLE
markers of README.md's port section is generated from the bench lines in
`headline/*.json` (one `python -m soillib_tpu_torch.bench` JSON line
each, saved verbatim from the card by `headline.py`), and
tests/test_torch_headline.py fails whenever the committed table disagrees
with a regeneration.

Usage:
  python -m soillib_tpu_torch.benchmarks.results_table --check   # exit 1 on drift
  python -m soillib_tpu_torch.benchmarks.results_table --write   # rewrite the block
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE = os.path.join(HERE, "headline")
README = os.path.join(os.path.dirname(os.path.dirname(HERE)), "README.md")
START = ("<!-- PORT-BENCH-TABLE-START (generated by "
         "soillib_tpu_torch/benchmarks/results_table.py; do not edit by "
         "hand) -->")
END = "<!-- PORT-BENCH-TABLE-END -->"


def build_table() -> str:
    rows = []
    for path in sorted(glob.glob(os.path.join(HEADLINE, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        rows.append(
            f"| {d['label']} | {d['ms_per_step']} "
            f"| {d['value'] / 1e6:.1f} | {d['vs_baseline']} "
            f"| {d['device']} | {d['note']} |"
        )
    head = (
        "| Config | ms/step | M gridpoint-steps/s | vs_baseline | Card | "
        "Notes |\n"
        "|---|---|---|---|---|---|"
    )
    return "\n".join([START, head] + rows + [END])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.benchmarks.results_table")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)

    table = build_table()
    with open(README) as f:
        text = f.read()
    if START not in text or END not in text:
        print(f"{README} has no PORT-BENCH-TABLE markers",
              file=sys.stderr)
        return 1
    pre, rest = text.split(START, 1)
    _, post = rest.split(END, 1)
    new = pre + table + post

    if args.write:
        with open(README, "w") as f:
            f.write(new)
        print(f"{README}: port table regenerated")
        return 0
    if new != text:
        print(f"{README}: the port's headline table is STALE against "
              f"{HEADLINE} -- run: python -m "
              "soillib_tpu_torch.benchmarks.results_table --write",
              file=sys.stderr)
        return 1
    print(f"{README}: port table consistent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
