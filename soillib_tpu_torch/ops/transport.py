"""Per-cell step-rule moments of the transport solvers (counterpart of
`soillib_tpu/ops/transport.py:73-188`).

The reference particles take one DDA cell-crossing step per round
(path.cu:27-49); the cohort solve needs the moments of that step over a
uniformly distributed within-cell position. The formulas, clips and
branch points are the JAX package's, kept exactly: the cohort kernel
(csrc/cohort_round.cu) repeats them and is held against this module.
"""

from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)


def stepsize_center(vx, vy):
    """The DDA step evaluated at cell centers (pos frac = 0.5): the
    per-cell mean crossing distance from unit-direction components.

    The small-component branch is double-where'd: min(0.5/a, sqrt2)
    equals sqrt2 exactly for a <= 0.5/sqrt2, and masking the division
    there keeps reverse mode free of 1/a^2 overflow (f32)."""
    def axis(a):
        capped = a <= 0.5 / _SQRT2
        return torch.where(capped, _SQRT2,
                           0.5 / torch.where(capped, 1.0, a))

    return 0.5 * (axis(torch.abs(vx)) + axis(torch.abs(vy)))


def stepsize_expected(vx, vy):
    """E_u[step] over a uniform within-cell position — the exact mean
    first-crossing distance of a uniformly-born particle: per axis with
    |d| = a, T = min(U/a, sqrt2), E[T] = 1/(2a) for a >= 1/sqrt2, else
    sqrt2 - a. Division masked for reverse-mode safety."""
    inv_s2 = 1.0 / _SQRT2

    def axis(a):
        big = a >= inv_s2
        return torch.where(big, 0.5 / torch.where(big, a, 1.0), _SQRT2 - a)

    return 0.5 * (axis(torch.abs(vx)) + axis(torch.abs(vy)))


def stepsize_var(vx, vy):
    """Var_u[step] over a uniform within-cell position, in the
    cancellation-free form
      Var[T] = (2*sqrt2/3)*a - a^2  for a < 1/sqrt2,
      Var[T] = 1/(12 a^2)           for a >= 1/sqrt2,
      Var[step] = (Var[Tx] + Var[Ty])/4."""
    def axis_var(a):
        big = a >= 1.0 / _SQRT2
        a_s = torch.where(big, a, 1.0)
        return torch.where(
            big, 1.0 / (12.0 * a_s * a_s), 0.9428090415820634 * a - a * a
        )

    return 0.25 * (axis_var(torch.abs(vx)) + axis_var(torch.abs(vy)))


def _expm1_k(x):
    """expm1 as the JAX kernel path computes it: cubic Taylor under
    |x| < 0.01, plain exp(x) - 1 elsewhere. Not `torch.expm1`: the cohort
    kernel and the JAX package use this decomposition, and the results
    must agree with both."""
    small = torch.abs(x) < 0.01
    series = x * (1.0 + x * (0.5 + x * (1.0 / 6.0)))
    return torch.where(small, series, torch.exp(x) - 1.0)


def expected_exp_step(vx, vy, coef):
    """E_u[exp(coef * step)] over a uniform within-cell position — the
    exact expected per-transit attenuation factor of a uniformly-born
    particle whose decay exponent is linear in the crossing distance:

      E[exp(beta T)] = (a/beta) expm1(beta u*/a) + max(0, 1-sqrt2 a) e^{sqrt2 beta}

    per axis at beta = coef/2, u* = min(1, sqrt2 a). Exponents are clipped
    to +-40 so the product of the two axis factors stays finite in f32.
    a -> 0 reduces to the pure sqrt2 cap."""
    def axis_mgf(a, beta):
        tiny_a = a < 1e-20
        a_s = torch.where(tiny_a, 1.0, a)
        u_star = torch.clamp(_SQRT2 * a, max=1.0)
        arg = torch.clamp(beta * u_star / a_s, -40.0, 40.0)
        small_b = torch.abs(beta) < 1e-12
        beta_s = torch.where(small_b, 1.0, beta)
        integral = torch.where(
            small_b, u_star, (a_s / beta_s) * _expm1_k(arg)
        )
        cap = torch.exp(torch.clamp(_SQRT2 * beta, -40.0, 40.0))
        tail = torch.clamp(1.0 - _SQRT2 * a, min=0.0) * cap
        full = integral + tail
        return torch.where(tiny_a, cap, full)

    beta = 0.5 * coef
    return axis_mgf(torch.abs(vx), beta) * axis_mgf(torch.abs(vy), beta)
