"""The port's block-decomposed particle estimators
(`parallel.solve_particles_sharded`, `fluvial_particles_sharded`,
`debris_particles_sharded`) against the single-device estimators of both
packages, on the CPU (tests/test_parallel.py holds the JAX package's
sharded estimators to those).

The port runs on 4 gloo ranks as a 2 x 2 mesh (one launch for the module;
tests/torch_parallel_ranks.py). Its births are the JAX package's own
uniforms, injected (`transport._birth_uniforms`), so every estimate uses
the same particle set. Bars are tests/test_parallel.py's: a 1 x 1 mesh is
bitwise the single-device estimator; on 2 x 2 the agreement is
statistical (a deposit cell is floor(pos), and the scatter into a cell
adds in another order): correlation >= 0.999, totals at rtol 1e-4, mean
relative difference < 0.01 for the uniform solve; >= 0.99 on the water,
mass and momentum channels and the water total at 5e-3 for the fluvial
estimator; >= 0.999 and 1e-4 on the debris mass. Zero drops, and an
overflow that degrades (counted drops, finite nonnegative flux).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.models import erosion as jero
from soillib_tpu_torch import parallel as par
from soillib_tpu_torch.convert import (
    params_from_frozen,
    state_from_numpy,
    state_to_numpy,
)
from soillib_tpu_torch.core.device import seeded_generator
from soillib_tpu_torch.testing import injected_births

from tests import torch_parallel_ranks as ranks

torch.set_num_threads(1)

ESCALE = (0.078, 0.078, 4.0)


def jax_uniforms(key, n):
    """The two birth draws of a JAX estimator called with `key`."""
    ka, kb = jax.random.split(key)
    return (np.array(jax.random.uniform(ka, (n,), jnp.float32)),
            np.array(jax.random.uniform(kb, (n,), jnp.float32)))


def _particle_problem(W=32, H=48):
    """tests/test_parallel.py's uniform-solve problem, from a numpy seed."""
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W))
    flow = np.stack([1.0 + 0.3 * np.sin(yy / 7.0), 0.4 * np.cos(xx / 9.0)],
                    axis=-1).astype(np.float32)
    source = np.abs(rng.normal(size=(W, H))).astype(np.float32)
    decay = (0.05 + 0.02 * rng.random((W, H))).astype(np.float32)
    return flow, source, decay, (0.5, 0.5)


def _erosion_state(amp, seed=0):
    """A 32^2 state after 3 field steps of the port (tests/test_parallel.py's
    recipe) as numpy fields, and JAX params with maxage 40 and 12000
    particles."""
    W = H = 32
    h = (2.0 + amp * np.random.default_rng(seed).normal(size=(W, H))
         ).astype(np.float32)
    p = jsoil.ErosionParams()
    p.transportIterations = 8
    p.maxage = 40
    p.nSamples = 12000
    st = soil.ErosionState.zeros((W, H), height=torch.from_numpy(h),
                                 device="cpu")
    st = soil.erode(st, ESCALE, params_from_frozen(p.freeze()), steps=3)
    return p, state_to_numpy(st)


FLOW = _particle_problem()
N_MIG = 20000
KEY_MIG = jax.random.PRNGKey(3)
D_MIG = [jax_uniforms(KEY_MIG, N_MIG)]
JP, FIELDS_F = _erosion_state(0.3)
_, FIELDS_D = _erosion_state(0.04)
P_FROZEN = params_from_frozen(JP.freeze()).freeze()
KEY_E = jax.random.PRNGKey(99)
D_E = [jax_uniforms(KEY_E, JP.nSamples)]
W_, H_ = 32, 48
_yy, _xx = np.meshgrid(np.arange(H_), np.arange(W_))
OVERFLOW = np.stack([np.where(_xx < 28, 1.0, 0.1),
                     np.where(_yy < 40, 1.0, 0.1)], -1).astype(np.float32)
CASES = [
    ("migration", "particles", dict(
        flow=FLOW[0], source=FLOW[1], decay=FLOW[2], scale=FLOW[3],
        count=N_MIG, draws=D_MIG, slack=2.0)),
    ("fluvial", "fluvial", dict(fields=FIELDS_F, frozen=P_FROZEN,
                                scale=ESCALE, draws=D_E)),
    ("debris", "debris", dict(fields=FIELDS_D, frozen=P_FROZEN,
                              scale=ESCALE, draws=D_E)),
    ("overflow", "particles", dict(
        flow=OVERFLOW, source=np.ones((W_, H_), np.float32),
        decay=np.full((W_, H_), 0.01, np.float32), scale=(0.5, 0.5),
        count=16000, draws=[jax_uniforms(jax.random.PRNGKey(1), 16000)],
        slack=1.0)),
]


@pytest.fixture(scope="module")
def got():
    return par.launch(ranks.run_cases, 4, transport="gloo",
                      devices=["cpu"] * 4, shape=(2, 2), args=(CASES,),
                      timeout=240)[0]


def _corr(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_one_block_mesh_is_bitwise_the_single_device_estimators():
    """1 x 1 mesh (no group): global births, the ownership take and the
    edge kills reduce to the single-device estimators, bitwise."""
    mesh = par.make_mesh(devices=["cpu"])
    flow, source, decay, scale = FLOW
    N = 8000
    draws = [jax_uniforms(jax.random.PRNGKey(0), N)]
    want = ranks.single_particles(flow, source, decay, scale, N, draws)
    with injected_births(draws):
        G, dropped = par.solve_particles_sharded(
            _t(flow), _t(source), _t(decay), scale, N,
            seeded_generator("cpu"), mesh, slack=2.0)
    assert dropped == 0
    np.testing.assert_array_equal(G.numpy(), want)

    p = params_from_frozen(P_FROZEN)
    st = state_from_numpy(FIELDS_F, "cpu")
    with injected_births(D_E):
        F, dropped = par.fluvial_particles_sharded(
            st.layers, st.rainfall, st.discharge, st.momentum,
            st.albedo_surface, ESCALE, p, seeded_generator("cpu"), mesh)
    assert dropped == 0
    np.testing.assert_array_equal(
        F.numpy(), ranks.single_fluvial(FIELDS_F, P_FROZEN, ESCALE, D_E))

    st = state_from_numpy(FIELDS_D, "cpu")
    with injected_births(D_E):
        F, dropped = par.debris_particles_sharded(
            st.layers, st.mass, st.momentum, st.albedo_surface, ESCALE, p,
            seeded_generator("cpu"), mesh)
    assert dropped == 0
    np.testing.assert_array_equal(
        F.numpy(), ranks.single_debris(FIELDS_D, P_FROZEN, ESCALE, D_E))


def test_migration_parity(got):
    """2 x 2 uniform solve with migration against the single-device
    estimator on the same particles (the port's and the JAX package's)."""
    from soillib_tpu.ops.transport import _solve_particles as jsolve

    flow, source, decay, scale = FLOW
    g = got["migration"]
    assert g["dropped"] == 0
    refs = (ranks.single_particles(flow, source, decay, scale, N_MIG, D_MIG),
            np.asarray(jsolve(jnp.asarray(flow), jnp.asarray(source),
                              jnp.asarray(decay), scale, N_MIG, KEY_MIG,
                              maxstep=flow.shape[0] + flow.shape[1])))
    for ref in refs:
        assert _corr(g["got"], ref) >= 0.999
        np.testing.assert_allclose(g["got"].sum(), ref.sum(), rtol=1e-4)
        assert np.abs(g["got"] - ref).mean() / np.abs(ref).mean() < 0.01


def _jfields(fields, *names):
    return [jnp.asarray(fields[k]) for k in names]


def test_sharded_fluvial_particles(got):
    """Fluvial MC on 2 x 2 against the port's single-device estimator and
    the JAX package's (channel-last there), the same births."""
    g = got["fluvial"]
    assert g["dropped"] == 0
    F = g["got"]
    jF = jero._fluvial_particles(
        *_jfields(FIELDS_F, "layers", "rainfall", "discharge", "momentum",
                  "albedo_surface"), ESCALE, JP, KEY_E)
    refs = (ranks.single_fluvial(FIELDS_F, P_FROZEN, ESCALE, D_E),
            np.asarray(jF))
    for ref in refs:
        assert F.shape == ref.shape
        for c in (0, 1, 2, 3):  # water, mass, momentum
            assert _corr(F[..., c], ref[..., c]) >= 0.99, c
        np.testing.assert_allclose(F[..., 0].sum(), ref[..., 0].sum(),
                                   rtol=5e-3)


def test_sharded_debris_particles(got):
    """Debris MC on 2 x 2 (physical-slope terrain) against the port's
    single-device estimator and the JAX package's."""
    g = got["debris"]
    assert g["dropped"] == 0
    F = g["got"]
    assert np.isfinite(F).all()
    jF = jero._debris_particles(
        *_jfields(FIELDS_D, "layers", "mass", "momentum", "albedo_surface"),
        ESCALE, JP, KEY_E)
    refs = (ranks.single_debris(FIELDS_D, P_FROZEN, ESCALE, D_E),
            np.asarray(jF))
    for ref in refs:
        assert F.shape == ref.shape
        assert _corr(F[..., 0], ref[..., 0]) >= 0.999
        np.testing.assert_allclose(F[..., 0].sum(), ref[..., 0].sum(),
                                   rtol=1e-4)


def test_overflow_is_graceful(got):
    """Everything concentrating into one block with slack 1.0: the
    overflowing particles die and are counted; the flux stays finite and
    nonnegative."""
    g = got["overflow"]
    assert g["dropped"] > 0
    assert np.isfinite(g["got"]).all()
    assert (g["got"] >= 0).all()
