"""The CUDA cohort kernel (soillib_tpu_torch/csrc/cohort_round.cu) against
the port's plain torch rounds on the card. This file imports no JAX, so it
runs where the card is:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest` because tests/conftest.py configures JAX for the CPU
suite). Every test carries the `cuda` marker and skips without a CUDA
device: the kernel has no CPU mode.

`cohort_arrays` is the JAX kernel tests' seeded recipe (tests/test_sweep.py
`_cohort_problem`) and `plain_exit_round` the adaptive-exit probe; both are
shared with tests/test_torch_cohort.py. Tolerances are the JAX package's
kernel-vs-reference bars: one round rtol 2e-6 / atol 1e-5, several rounds
rtol 2e-5 / atol 1e-5 on the deposits.
"""

import math

import numpy as np
import pytest
import torch

from soillib_tpu_torch.models import erosion
from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.ops import cohort

LLEN = math.sqrt(0.02)  # cell diagonal at scale (0.1, 0.1)
TOL = 1e-6
CASES = [("fluvial", True), ("fluvial", False), ("debris", True),
         ("debris", False)]


def cohort_arrays(kind, albedo, W=72, H=60, seed=0, mass_scale=1.0,
                  aux3_scale=1.0):
    """Seeded cohort state (S, W, H) and aux (4, W, H), float32 numpy."""
    rng = np.random.default_rng(seed)
    C = (7 if albedo else 4) if kind == "fluvial" else (6 if albedo else 3)
    w0 = np.abs(rng.normal(size=(W, H))) + 0.5
    sp = rng.normal(size=(2, W, H)) * 3.0
    carried = np.abs(rng.normal(size=(C, W, H)))
    carried[0] *= mass_scale
    accel = rng.normal(size=(2, W, H))
    if kind == "fluvial":
        aux3 = -np.abs(rng.normal(size=(W, H))) * aux3_scale  # decay rate
    else:
        aux3 = 0.5 * rng.normal(size=(W, H))                  # excess slope
    st = np.concatenate([np.stack([
        w0, w0 * sp[0], w0 * sp[1], w0 * sp[0] ** 2, w0 * sp[1] ** 2,
        w0 * sp[0] * sp[1], w0 * 0.5, w0 * 0.5, w0 / 3.0, w0 / 3.0]),
        carried]).astype(np.float32)
    aux = np.concatenate([accel, np.ones((1, W, H)), aux3[None]]).astype(
        np.float32)
    return st, aux


def port_rules(kind, albedo, W, H, params=None):
    """The port's real rule set of `kind` for a W x H grid."""
    p = params or ErosionParams()
    if kind == "fluvial":
        return erosion.make_fluvial_rules(p, LLEN, albedo)
    return erosion.make_debris_rules(p, LLEN, p.nSamples / (W * H), albedo)


def plain_exit_round(st, aux, rules, iters, tol=TOL):
    """First round at which the plain path's adaptive criterion fires
    (checked before every round, as `cohort_advance_reference` does), on
    the tensors' device; `iters` if it never does."""
    G = torch.zeros((st.shape[0] - cohort.NSTATE,) + tuple(st.shape[1:]),
                    device=st.device)
    for i in range(iters):
        if bool(cohort.tail_converged(
                cohort.carried_live(st), cohort.deposit_gauge(G), iters - i,
                tol, rules.contractive)):
            return i
        st, G = cohort.cohort_round(st, G, aux, rules, LLEN)
    return iters


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol, err_msg=msg)


def _on_card(st, aux):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cohort kernel has no CPU mode")
    return torch.from_numpy(st).cuda(), torch.from_numpy(aux).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,albedo", CASES)
def test_kernel_matches_plain_on_card(kind, albedo):
    """One round (state and deposits) and 16 rounds (deposits), and one
    launch counted per round."""
    st, aux = _on_card(*cohort_arrays(kind, albedo, seed=5))
    tr = port_rules(kind, albedo, 72, 60)
    C = st.shape[0] - cohort.NSTATE
    G = torch.zeros((C,) + tuple(st.shape[1:]), device="cuda")
    n0 = cohort.cohort_round_launches[kind]
    st_k = cohort.cohort_round_cuda(st, aux, G, tr, LLEN)
    st_p, G_p = cohort.cohort_round(st, torch.zeros_like(G), aux, tr, LLEN)
    _close(st_k, st_p, 2e-6, 1e-5, "state")
    _close(G, G_p, 2e-6, 1e-5, "deposits")
    _, g_k = cohort.cohort_advance_cuda(st, aux, tr, 16, LLEN)
    _, g_p = cohort.cohort_advance_reference(st, aux, tr, 16, LLEN)
    _close(g_k, g_p, 2e-5, 1e-5, "16-round deposits")
    assert cohort.cohort_round_launches[kind] == n0 + 17


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["contractive", "live-zero"])
def test_kernel_adaptive_exit_on_card(mode):
    """The kernel path's `tol` exit, read every TOL_CHECK_ROUNDS rounds,
    in both modes (the problems of test_torch_cohort.py's
    `test_adaptive_exit_matches_jax`). It runs the plain path's exit round
    rounded up to the next check; its deposits match the plain adaptive
    solve within the multi-round bar plus what the extra rounds may add
    (tol times the channel's deposit gauge), and its own fixed-depth solve
    within 2e-6 (past the exit the tail is below tol, or exactly zero)."""
    iters = 88
    if mode == "contractive":
        p = ErosionParams()
        p.evapRate = 50.0
        p.depositionRateFluvial = 50.0
        st, aux = cohort_arrays("fluvial", True, 48, 40, seed=3,
                                aux3_scale=50.0)
        tr = port_rules("fluvial", True, 48, 40, p)
        assert tr.contractive
    else:
        st, aux = cohort_arrays("debris", True, 48, 40, seed=4,
                                mass_scale=1e-4)
        tr = port_rules("debris", True, 48, 40)
        assert not tr.contractive
    st, aux = _on_card(st, aux)
    exit_plain = plain_exit_round(st, aux, tr, iters)
    assert 0 < exit_plain < iters // 2, f"exit at {exit_plain}/{iters}"
    every = cohort.TOL_CHECK_ROUNDS
    n0 = cohort.cohort_round_launches[tr.kind]
    _, g_k = cohort.cohort_advance_cuda(st, aux, tr, iters, LLEN, tol=TOL)
    rounds = cohort.cohort_round_launches[tr.kind] - n0
    assert rounds == min(iters, -(-exit_plain // every) * every), (
        rounds, exit_plain)

    _, g_p = cohort.cohort_advance_reference(st, aux, tr, iters, LLEN,
                                             tol=TOL)
    tail = TOL * cohort.deposit_gauge(g_p)[:, None, None]
    err = (g_k - g_p).abs()
    assert bool((err <= 1e-5 + tail + 2e-5 * g_p.abs()).all()), (
        f"adaptive deposits vs plain: max abs err {float(err.max()):.3e}")
    _, g_fix = cohort.cohort_advance_cuda(st, aux, tr, iters, LLEN)
    _close(g_k, g_fix, 2e-6, 1e-6, "adaptive vs fixed depth")
