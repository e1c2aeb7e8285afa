"""The port's multiscale cascade (`resize_state`, `level_scale`,
`run_cascade`) against the JAX package on the CPU: twins of
tests/test_multiscale.py's single-device tests, `resize_state` on full
and on constant fields, and a 16^2 -> 32^2 cascade at the multi-round
cohort bar of tests/test_torch_erosion.py (rtol 2e-5, atol 1e-5 of each
field's scale)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu_torch.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(1)


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=msg)


def _init_state(res):
    h = soil.noise(res, soil.noise_t(ext=(64.0, 64.0)), device="cpu") \
        * 0.5 + 2.0
    return soil.ErosionState.zeros(res, height=h, device="cpu")


def _jax_state(state):
    return jsoil.ErosionState(**{k: jnp.asarray(v) for k, v in
                                 state_to_numpy(state).items()})


def test_resize_state_resamples_all_fields():
    st = _init_state((32, 32))
    st2 = soil.resize_state(st, (64, 48))
    assert st2.layers.shape == (2, 64, 48)
    assert st2.momentum.shape == (2, 64, 48)
    assert st2.albedo_surface.shape == (3, 64, 48)
    # Bilinear upsample preserves the mean height closely.
    np.testing.assert_allclose(
        float(st2.height.mean()), float(st.height.mean()), rtol=1e-2
    )


def test_level_scale_matches_reference_formula():
    # pscale = wscale / res (erosion_gpu_multiscale.py:107-109)
    assert soil.level_scale((80.0, 40.0), 4.0, (128, 64)) == (
        80.0 / 128, 40.0 / 64, 4.0)
    assert soil.level_scale((80.0, 40.0), 4.0, (128, 64)) == \
        jsoil.level_scale((80.0, 40.0), 4.0, (128, 64))


def test_cascade_runs_coarse_to_fine():
    param = soil.ErosionParams()
    param.transportIterations = 4
    st = _init_state((16, 16))
    seen = []
    out = soil.run_cascade(
        st,
        levels=[((16, 16), 2), ((32, 32), 1)],
        world_extent=(20.0, 20.0),
        zscale=4.0,
        param=param,
        on_level=lambda i, res, s: seen.append((i, res)),
    )
    assert seen == [(0, (16, 16)), (1, (32, 32))]
    assert out.rainfall.shape == (32, 32)
    assert bool(torch.isfinite(out.height).all())


def test_resize_state_full_fields_match_jax():
    rng = np.random.default_rng(0)
    fields = {k: rng.random(v.shape).astype(np.float32) for k, v in
              state_to_numpy(_init_state((20, 14))).items()}
    st = state_from_numpy(fields, "cpu")
    for res in ((37, 29), (9, 11)):
        got = state_to_numpy(soil.resize_state(st, res))
        want = jsoil.resize_state(_jax_state(st), res)
        for k, v in got.items():
            np.testing.assert_allclose(v, np.asarray(getattr(want, k)),
                                       rtol=2e-6, atol=1e-6, err_msg=k)


def test_resize_state_keeps_constant_fields_constant():
    """(1, 1) rainfall and uplift and (3, 1, 1) albedos stay those
    constants; every full field resizes as the JAX package resizes the
    state with the constants spread to full size."""
    h = np.random.default_rng(1).random((20, 14)).astype(np.float32)
    st = soil.ErosionState.zeros((20, 14), height=h, rainfall=1.5,
                                 uplift=0.25, albedo_bedrock=(0.1, 0.2, 0.3),
                                 albedo_surface=(0.4, 0.5, 0.6),
                                 device="cpu")
    got = soil.resize_state(st, (33, 27))
    full = st.replace(**{
        f.name: getattr(st, f.name).expand(
            *getattr(st, f.name).shape[:-2], 20, 14)
        for f in dataclasses.fields(st)})
    want = jsoil.resize_state(_jax_state(full), (33, 27))
    for f in dataclasses.fields(got):
        g, src = getattr(got, f.name), getattr(st, f.name)
        if tuple(src.shape[-2:]) == (1, 1):
            assert g is src, f.name
            g = g.expand(*g.shape[:-2], 33, 27)
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(getattr(want, f.name)),
                                   rtol=2e-6, atol=1e-6, err_msg=f.name)


def test_cascade_matches_jax():
    """16^2 for 2 steps, then 32^2 for 1 step, 4 transport rounds."""
    p = soil.ErosionParams()
    p.transportIterations = 4
    jp = jsoil.ErosionParams()
    for name, value in p.freeze():
        setattr(jp, name, value)
    st = _init_state((16, 16))
    kw = dict(levels=[((16, 16), 2), ((32, 32), 1)],
              world_extent=(20.0, 20.0), zscale=4.0)
    got = state_to_numpy(soil.run_cascade(st, param=p, **kw))
    want = jsoil.run_cascade(_jax_state(st), param=jp,
                             key=jax.random.PRNGKey(0), **kw)
    assert got["layers"].shape == (2, 32, 32)
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        if f.name == "albedo_debris":
            # A ratio of deposits, ill-conditioned where the debris mass
            # is ~nothing (tests/test_torch_erosion.py): compare the
            # albedo mass it stands for.
            _close(got[f.name] * got["debris"], w * np.asarray(want.debris),
                   "albedo_debris x debris")
        else:
            _close(got[f.name], w, f.name)


def test_cascade_with_a_mesh_raises():
    """A mesh that is not a `parallel.Mesh` raises (the sharded cascade
    itself is held in tests/test_torch_parallel.py)."""
    st = _init_state((16, 16))
    with pytest.raises(TypeError, match="parallel.Mesh"):
        soil.run_cascade(st, [((16, 16), 1)], (20.0, 20.0), 4.0,
                         soil.ErosionParams(), mesh=object())
