"""The PyTorch port's transports and coupled step against the JAX package on
the CPU, and the port's trajectory against the JAX package's golden.

Single solves and one step compare elementwise at the multi-round cohort
bar, rtol 2e-5 with an absolute floor of 1e-5 of each field's scale
(tests/test_sweep.py: f32 reassociation noise through the nonlinear
rounds). The 10-step trajectory is held to tests/test_golden.py's GOLDEN
statistics at its rtol of 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.models.simulation import erode_step as jax_erode_step
from soillib_tpu_torch.convert import (
    params_from_frozen,
    state_from_numpy,
    state_to_numpy,
)
from soillib_tpu_torch.models.simulation import erode_step
from tests.test_golden import GOLDEN

torch.set_num_threads(1)

W, H = 48, 40
SCALE = (0.1, 0.1, 4.0)


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=msg)


def _state_fields(seed=0):
    """A seeded mid-run state: rough terrain (slopes on both sides of the
    landslide threshold), water, sediment, debris, momentum and albedos."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    u = lambda *s: rng.uniform(size=s).astype(np.float32)
    bed = 2.0 + 0.01 * np.cumsum(np.cumsum(f(W, H), axis=0), axis=1)
    return dict(
        layers=np.stack([bed, np.abs(f(W, H)) * 0.01]),
        rainfall=np.ones((W, H), np.float32),
        uplift=u(W, H),
        discharge=np.abs(f(W, H)),
        mass=np.abs(f(W, H)) * 1e-6,
        momentum=f(2, W, H) * 0.1,
        debris=np.abs(f(W, H)) * 1e-3,
        debris_momentum=f(2, W, H) * 0.1,
        albedo_bedrock=u(3, W, H),
        albedo_surface=u(3, W, H),
        albedo_fluvial=u(3, W, H),
        albedo_debris=u(3, W, H),
    )


def _params():
    """(port, JAX) default parameters at 16 transport rounds."""
    p = soil.ErosionParams()
    p.transportIterations = 16
    jp = jsoil.ErosionParams()
    for name, value in p.freeze():
        setattr(jp, name, value)
    return p, jp


def test_transport_fluvial_matches_jax():
    fl = _state_fields(1)
    p, jp = _params()
    keys = ("layers", "rainfall", "discharge", "mass", "momentum",
            "albedo_surface")
    got = soil.transport_fluvial(
        *[torch.from_numpy(fl[k]) for k in keys], SCALE, p)
    want = jsoil.transport_fluvial(*[jnp.asarray(fl[k]) for k in keys],
                                   SCALE, jp)
    for name, g, w in zip(("discharge", "mass", "momentum", "albedo"),
                          got, want):
        _close(g, w, name)


def test_transport_debris_matches_jax():
    fl = _state_fields(2)
    p, jp = _params()
    keys = ("layers", "debris", "debris_momentum", "albedo_surface")
    got = soil.transport_debris(
        *[torch.from_numpy(fl[k]) for k in keys], SCALE, p)
    want = jsoil.transport_debris(*[jnp.asarray(fl[k]) for k in keys],
                                  SCALE, jp)
    assert float(np.abs(np.asarray(want[0])).max()) > 0.0  # debris moved
    for name, g, w in zip(("debris", "momentum"), got, want):
        _close(g, w, name)
    # The transported albedo is a ratio of deposits, ill-conditioned where
    # the debris mass is ~1e-12 of nothing (cohorts near the yield-stress
    # switch): compare the albedo mass it stands for.
    _close(got[2] * got[0], np.asarray(want[2]) * np.asarray(want[0]),
           "albedo x debris")


def test_erode_step_matches_jax():
    fl = _state_fields(3)
    p, jp = _params()
    out = state_to_numpy(erode_step(state_from_numpy(fl, "cpu"), SCALE, p))
    jstate = jsoil.ErosionState(**{k: jnp.asarray(v) for k, v in fl.items()})
    ref = jax.jit(lambda s: jax_erode_step(s, SCALE, jp))(jstate)
    for f in dataclasses.fields(ref):
        want = np.asarray(getattr(ref, f.name))
        if f.name == "albedo_debris":
            # A ratio of deposits (see test_transport_debris_matches_jax).
            _close(out[f.name] * out["debris"],
                   want * np.asarray(ref.debris), "albedo_debris x debris")
        else:
            _close(out[f.name], want, f.name)


def test_params_cross_packages():
    """A JAX configuration, closure included, arrives as the same port
    configuration."""
    jp = jsoil.ErosionParams()
    jp.transportIterations = 7
    jp.closure = jsoil.CohortClosure()
    p = params_from_frozen(jp.freeze())
    assert p.transportIterations == 7
    assert p.closure == soil.CohortClosure()
    assert dict(p.freeze())["maxage"] == jp.maxage


def test_erosion_trajectory_matches_golden():
    """tests/test_golden.py's trajectory (64^2, 16 rounds, 10 steps) on the
    port's plain path; the terrain is the JAX package's noise, as numpy."""
    param = soil.ErosionParams()
    param.transportIterations = 16
    h = jsoil.noise((64, 64), jsoil.noise_t(seed=5.0, ext=(64.0, 64.0)))
    h = np.asarray(h) * 0.5 + 2.0
    state = soil.ErosionState.zeros((64, 64), height=h, device="cpu")
    state = soil.erode(state, (0.1, 0.1, 4.0), param, steps=10)
    for name, (mean, std, absmax) in GOLDEN.items():
        arr = getattr(state, name).numpy()
        np.testing.assert_allclose(arr.mean(), mean, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(arr.std(), std, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(np.abs(arr).max(), absmax, rtol=1e-3,
                                   err_msg=name)


@pytest.mark.cuda
def test_erode_kernel_path_matches_plain():
    """The whole step through the CUDA kernel against the plain path on the
    CPU, at the golden tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cohort kernel has no CPU mode")
    fl = _state_fields(4)
    p, _ = _params()
    out = {dev: state_to_numpy(soil.erode(state_from_numpy(fl, dev), SCALE,
                                          p, steps=2))
           for dev in ("cuda", "cpu")}
    for name in ("layers", "discharge", "momentum", "debris"):
        np.testing.assert_allclose(out["cuda"][name], out["cpu"][name],
                                   rtol=1e-3,
                                   atol=1e-5 * np.abs(out["cpu"][name]).max(),
                                   err_msg=name)
