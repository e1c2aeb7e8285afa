"""The PyTorch port's cohort solve (soillib_tpu_torch/ops/cohort.py) against
the JAX package's reference path, both on the CPU, with the real fluvial and
debris rule sets, albedo on and off.

Inputs are made from a numpy seed with the JAX kernel tests' recipe
(tests/test_sweep.py `_cohort_problem`, kept in tests/test_torch_cuda.py
beside the kernel's tests on the card). Tolerances are the JAX package's
own kernel-vs-reference bars: one round rtol 2e-6 / atol 1e-5 (state and
deposits), several rounds rtol 2e-5 / atol 1e-5 on the deposits (f32
reassociation noise grows through the nonlinear round body).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soillib_tpu.models import erosion as jax_erosion
from soillib_tpu.models.params import ErosionParams as JaxParams
from soillib_tpu.ops import cohort as jax_cohort
from soillib_tpu_torch.models import erosion as port_erosion
from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.ops import cohort as port_cohort
from tests.test_torch_cuda import (
    CASES,
    LLEN,
    TOL,
    cohort_arrays,
    plain_exit_round,
)

torch.set_num_threads(1)


def _problem(kind, albedo, W=72, H=60, seed=0, mass_scale=1.0,
             params=None, aux3_scale=1.0):
    """(st, aux) float32 numpy arrays and the (jax, torch) rule sets."""
    st, aux = cohort_arrays(kind, albedo, W, H, seed, mass_scale, aux3_scale)
    frozen = (params or ErosionParams()).freeze()
    jp = JaxParams()
    for name, value in frozen:
        setattr(jp, name, value)
    pp = ErosionParams.from_frozen(frozen)
    if kind == "fluvial":
        rules = (jax_erosion.make_fluvial_rules(jp, LLEN, albedo),
                 port_erosion.make_fluvial_rules(pp, LLEN, albedo))
    else:
        rho = pp.nSamples / (W * H)
        rules = (jax_erosion.make_debris_rules(jp, LLEN, rho, albedo),
                 port_erosion.make_debris_rules(pp, LLEN, rho, albedo))
    return st, aux, rules


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_norm_cdf_and_axis_streams():
    """The Abramowitz-Stegun CDF and the truncated-Gaussian stream
    decomposition, including deterministic (zero-variance) ensembles and
    the |z| = 6 cap."""
    rng = np.random.default_rng(1)
    z = np.concatenate([np.linspace(-8, 8, 161),
                        rng.normal(size=300) * 3]).astype(np.float32)
    gauss = np.exp(-0.5 * z * z).astype(np.float32)
    _close(port_cohort._norm_cdf(_t(z), _t(gauss)),
           jax_cohort._norm_cdf(jnp.asarray(z), jnp.asarray(gauss)),
           2e-7, 1e-7)

    mu = (rng.normal(size=(40, 30)) * 3).astype(np.float32)
    var = np.abs(rng.normal(size=(40, 30))).astype(np.float32)
    var[:10] = 0.0                      # deterministic ensembles
    var[10:15] = 1e-6 * mu[10:15] ** 2  # nearly deterministic: |z| cap
    mu[:3, :5] = 0.0                    # P(v > 0) = 1/2 branch
    m2 = (mu * mu + var).astype(np.float32)
    got = port_cohort._axis_streams(_t(mu), _t(m2))
    want = jax_cohort._axis_streams(jnp.asarray(mu), jnp.asarray(m2))
    # rtol 2e-6 of each output's scale: for z < -3 the CDF is
    # 1 - poly*gauss, a cancellation that turns ulp-level differences in
    # exp into absolute (not relative) differences of the conditional
    # moments, which then cancel against mu.
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        _close(g, w, 2e-6, 2e-6 * np.abs(w).max(), f"output {i}")


@pytest.mark.parametrize("kind,albedo", CASES)
def test_cohort_round_matches_jax(kind, albedo):
    st, aux, (jr, tr) = _problem(kind, albedo)
    C = st.shape[0] - port_cohort.NSTATE
    G0 = np.zeros((C,) + st.shape[1:], np.float32)
    ja, jg = jax_cohort.cohort_round(jnp.asarray(st), jnp.asarray(G0),
                                     jnp.asarray(aux), jr, LLEN,
                                     jax_cohort.shift_push)
    ta, tg = port_cohort.cohort_round(_t(st), _t(G0), _t(aux), tr, LLEN)
    _close(ta, ja, 2e-6, 1e-5, "state")
    _close(tg, jg, 2e-6, 1e-5, "deposits")


@pytest.mark.parametrize("kind,albedo", CASES)
def test_cohort_advance_reference_matches_jax(kind, albedo):
    """16 rounds (one JAX kernel pass) and 21 (a pass plus a remainder)."""
    st, aux, (jr, tr) = _problem(kind, albedo, seed=2)
    for iters in (16, 21):
        _, jg = jax_cohort.cohort_advance_reference(
            jnp.asarray(st), jnp.asarray(aux), jr, iters, LLEN)
        _, tg = port_cohort.cohort_advance_reference(
            _t(st), _t(aux), tr, iters, LLEN)
        _close(tg, jg, 2e-5, 1e-5, f"deposits after {iters} rounds")


def _exit_round_jax(st, aux, rules, iters):
    """The same probe on the JAX package (jitted round)."""
    aux = jnp.asarray(aux)
    contractive = bool(getattr(rules, "contractive", False))
    step = jax.jit(lambda s, g: jax_cohort.cohort_round(
        s, g, aux, rules, LLEN, jax_cohort.shift_push))
    st = jnp.asarray(st)
    G = jnp.zeros((st.shape[0] - jax_cohort.NSTATE,) + st.shape[1:])
    for i in range(iters):
        if bool(jax_cohort.tail_converged(
                jax_cohort.carried_live(st), jax_cohort.deposit_gauge(G),
                iters - i, TOL, contractive)):
            return i
        st, G = step(st, G)
    return iters


@pytest.mark.parametrize("mode", ["contractive", "live-zero"])
def test_adaptive_exit_matches_jax(mode):
    """The `tol` exit in both modes: fluvial rules are contractive and use
    the live x remaining-rounds bound (strong decay rates make it bite);
    debris rules exit only once the live carried mass is exactly zero
    (physical debris masses collapse every cohort's speed within a few
    rounds). The port exits at the JAX round and its deposits match JAX's
    and its own fixed-depth solve.

    XLA flushes subnormal floats to zero and torch does not (unless the
    process's float mode was left flushing by whatever ran before). The
    live-zero exit comes as the last carried mass decays through the
    subnormal range, where a subnormal cohort weight still counts as alive
    in torch, so there the port may exit one round after JAX; what it adds
    in that round is below the smallest normal float."""
    iters = 88  # W + H
    if mode == "contractive":
        p = ErosionParams()
        p.evapRate = 50.0
        p.depositionRateFluvial = 50.0
        st, aux, (jr, tr) = _problem("fluvial", True, 48, 40, seed=3,
                                     params=p, aux3_scale=50.0)
        assert tr.contractive
    else:
        st, aux, (jr, tr) = _problem("debris", True, 48, 40, seed=4,
                                     mass_scale=1e-4)
        assert not tr.contractive
    exit_port = plain_exit_round(_t(st), _t(aux), tr, iters)
    exit_jax = _exit_round_jax(st, aux, jr, iters)
    if mode == "contractive":
        assert exit_port == exit_jax
    else:
        assert exit_port - exit_jax in (0, 1), (exit_port, exit_jax)
    assert 0 < exit_port < iters // 2, f"exit at {exit_port}/{iters}"

    _, g_ad = port_cohort.cohort_advance_reference(_t(st), _t(aux), tr,
                                                   iters, LLEN, tol=TOL)
    _, g_fix = port_cohort.cohort_advance_reference(_t(st), _t(aux), tr,
                                                    iters, LLEN)
    _, g_jax = jax_cohort.cohort_advance_reference(
        jnp.asarray(st), jnp.asarray(aux), jr, iters, LLEN, tol=TOL)
    _close(g_ad, g_jax, 2e-5, 1e-5, "adaptive deposits vs JAX")
    # Past the exit the tail is below tol of the deposits (contractive) or
    # exactly zero (live-zero).
    _close(g_ad, g_fix, 2e-6, 1e-6, "adaptive vs fixed depth")
