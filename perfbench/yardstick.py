"""The benchmark's fixed yardstick: the card's peaks, the reference's work
per cohort round, and the byte model. Copied here and frozen, so that no
change of the measured program moves them.

* Peaks of one NVIDIA H100 SXM (data sheet, 700 W): 67 TFLOP/s FP32
  outside the tensor cores, which counts an FMA twice, so 3.345e13
  fma-equivalents/s = 132 SMs x 128 lanes x 1980 MHz; 3.35 TB/s HBM3.
* `ROUND_OPS`: operations per cell of one cohort round of the reference
  (the JAX package's jaxpr, counted by weight class: simple, exp, div,
  sqrt), at albedo on and off.
* `COST`: fma-equivalents of one exp, div and sqrt, as measured on the
  H100 by the FP32 chain probe (exp 8.6, div 16.4, sqrt 11.7).
* The byte model: per pass of K = 16 rounds a cell reads its (NSTATE + C)
  state channels, 4 aux channels and C deposits, writes state and
  deposits, and copies the state back (read + write), 4 bytes each.
* The particle estimators' bytes a live particle-round, from the plain
  round of `perfbench/reference/step.py` (`_particle_rounds` with each
  estimator's `advance`), not from any kernel's layout: a particle's own
  position, speed and attenuations stay with it (registers), so what a
  round must move is one 4-byte read of each per-cell field that
  `advance` gathers at the particle's cell `ind`, and one 4-byte write of
  each channel that the round deposits into the flux. Fluvial gathers gx,
  gy, mx, my and the discharge (5) and deposits water, mass, two momenta
  and three albedos (C = 7): 48 B. Debris gathers gx, gy, mx, my (4) and
  deposits mass, two momenta and three albedos (C = 6): 40 B.
"""

from __future__ import annotations

FP32_FMA_PER_S = 132 * 128 * 1980e6
HBM_BYTES_PER_S = 3.35e12

ROUND_OPS = {
    ("fluvial", True): (891.1923828125, 10.0, 33.0, 9.0),
    ("debris", True): (919.2021484375, 14.0, 40.0, 9.0),
    ("fluvial", False): (824.1572265625, 10.0, 33.0, 9.0),
    ("debris", False): (868.1669921875, 14.0, 40.0, 9.0),
}
COST = {"exp": 8.6, "div": 16.4, "sqrt": 11.7}

K_ROUNDS_PER_PASS = 16
NSTATE = 10
CARRIED = {("fluvial", True): 7, ("debris", True): 6,
           ("fluvial", False): 4, ("debris", False): 3}


def round_ops(kind: str, albedo: bool) -> float:
    """Weighted fma-equivalents per cell of one round of `kind`."""
    simple, n_exp, n_div, n_sqrt = ROUND_OPS[(kind, albedo)]
    return (simple + n_exp * COST["exp"] + n_div * COST["div"]
            + n_sqrt * COST["sqrt"])


def round_bytes(kind: str, albedo: bool) -> float:
    """Bytes per cell of one round under the K = 16 byte model."""
    C = CARRIED[(kind, albedo)]
    S = NSTATE + C
    per_pass = (S + 4 + C) * 4 + (S + C) * 4 + 2 * S * 4
    return per_pass / K_ROUNDS_PER_PASS


def round_bound_s(kind: str, albedo: bool, cells: int) -> float:
    """The least time of one round over `cells` cells: the larger of the
    operations over the FP32 rate and the bytes over the HBM rate."""
    return max(round_ops(kind, albedo) * cells / FP32_FMA_PER_S,
               round_bytes(kind, albedo) * cells / HBM_BYTES_PER_S)


# (fields gathered at `ind` by `advance`, channels deposited) of the plain
# round, per estimator.
PARTICLE_FIELDS = {"fluvial": (5, 7), "debris": (4, 6)}


def particle_round_bytes(kind: str) -> float:
    """Bytes one live particle-round of estimator `kind` must move."""
    gathered, deposited = PARTICLE_FIELDS[kind]
    return 4.0 * (gathered + deposited)
