"""Two parity records side by side (`parity.py --out`, or the JAX
harness's `benchmarks/parity.py --out`): per terrain, regime, phase and
field the field-vs-MC correlation, relative mean error and the MC's
split-half self-correlation of each; per terrain and field of the
coupled runs the field-vs-MC and MC-vs-MC numbers of each. Two runs with
other random draws (the card's Philox against JAX's threefry) agree
within the MC's noise: where both self-correlations are at least
SIGNAL_SELFCORR, the correlations lie within CORR_NOISE of each other.

    python -m soillib_tpu_torch.benchmarks.compare_records A.json B.json

prints a markdown table of each kind and the fields outside that bound.
"""

from __future__ import annotations

import argparse
import json

SIGNAL_SELFCORR = 0.99
CORR_NOISE = 0.02


def single_phase_rows(a: dict, b: dict) -> list:
    """(terrain, regime, phase, field, metrics of a, metrics of b) of
    every single-phase comparison in both records."""
    rows = []
    for terrain in a:
        if terrain in ("config", "nsamples") or terrain not in b:
            continue
        for regime in ("cold", "warm"):
            for phase, fields in a[terrain].get(regime, {}).items():
                for field, ma in fields.items():
                    rows.append((terrain, regime, phase, field, ma,
                                 b[terrain][regime][phase][field]))
    return rows


def coupled_rows(a: dict, b: dict) -> list:
    """(terrain, field, metrics of a, metrics of b) of the coupled runs
    of both records."""
    return [(t, field, m, b[t]["coupled"][field])
            for t in a if isinstance(a[t], dict) and "coupled" in a[t]
            and "coupled" in b.get(t, {})
            for field, m in a[t]["coupled"].items()]


def outside_noise(a: dict, b: dict) -> list:
    """The single-phase rows whose correlations differ by more than
    CORR_NOISE where both MCs carry signal (self-corr >= SIGNAL_SELFCORR)."""
    return [r for r in single_phase_rows(a, b)
            if min(r[4]["mc_selfcorr"], r[5]["mc_selfcorr"]) >= SIGNAL_SELFCORR
            and abs(r[4]["corr"] - r[5]["corr"]) > CORR_NOISE]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m soillib_tpu_torch.benchmarks.compare_records")
    ap.add_argument("a")
    ap.add_argument("b")
    args = ap.parse_args(argv)
    with open(args.a) as f:
        a = json.load(f)
    with open(args.b) as f:
        b = json.load(f)
    print(f"A: {args.a} ({a.get('device', 'device not recorded')})\n"
          f"B: {args.b} ({b.get('device', 'device not recorded')})\n")
    print("| terrain | regime | phase | field | corr A | corr B | |Δcorr| "
          "| self-corr A | self-corr B | rel_mean A | rel_mean B |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")
    for t, reg, ph, fld, ma, mb in single_phase_rows(a, b):
        print(f"| {t} | {reg} | {ph} | {fld} | {ma['corr']:.4f} | "
              f"{mb['corr']:.4f} | {abs(ma['corr'] - mb['corr']):.4f} | "
              f"{ma['mc_selfcorr']:.4f} | {mb['mc_selfcorr']:.4f} | "
              f"{ma['rel_mean']:.4f} | {mb['rel_mean']:.4f} |")
    print("\n| terrain | field | field-vs-MC corr A | B | relmean A | B | "
          "MC-vs-MC corr A | B | relmean A | B |\n"
          "|---|---|---|---|---|---|---|---|---|---|")
    for t, fld, ma, mb in coupled_rows(a, b):
        print(f"| {t} | {fld} | {ma['field_vs_mc_corr']:.4f} | "
              f"{mb['field_vs_mc_corr']:.4f} | "
              f"{ma['field_vs_mc_relmean']:.4f} | "
              f"{mb['field_vs_mc_relmean']:.4f} | "
              f"{ma['mc_vs_mc_corr']:.4f} | {mb['mc_vs_mc_corr']:.4f} | "
              f"{ma['mc_vs_mc_relmean']:.4f} | {mb['mc_vs_mc_relmean']:.4f} |")
    out = outside_noise(a, b)
    print(f"\n{len(out)} field(s) outside |Δcorr| <= {CORR_NOISE} where "
          f"both self-corr >= {SIGNAL_SELFCORR}: "
          f"{[r[:4] for r in out]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
