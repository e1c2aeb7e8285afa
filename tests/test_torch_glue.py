"""The PyTorch port's step glue against the JAX package, on the CPU: the
Godunov gradient, the birth density, the step-rule moments, mass transfer
and creep (soillib_tpu_torch/models/erosion.py, ops/transport.py).

Inputs come from a numpy seed on a 37x53 grid (odd sizes, so the x and y
axes cannot be confused). Tolerance rtol 1e-6: these are elementwise
formulas, equal up to float32 rounding; the absolute floor (1e-6 of the
field's scale) covers results that cancel to near zero.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soillib_tpu.models import erosion as jax_erosion
from soillib_tpu.models.params import ErosionParams as JaxParams
from soillib_tpu.ops import transport as jax_transport
from soillib_tpu_torch.models import erosion as port_erosion
from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.ops import transport as port_transport

torch.set_num_threads(1)

W, H = 37, 53
SCALE = (0.1, 0.13, 4.0)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, msg=""):
    want = np.asarray(want)
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=atol,
                               err_msg=msg)


def _fields(seed=0):
    """A seeded erosion state's fields: terrain with slopes on both sides
    of the landslide threshold, positive water/mass/debris, momentum,
    albedos in [0, 1] and bare-sediment cells."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    u = lambda *s: rng.uniform(size=s).astype(np.float32)
    sed = np.abs(f(W, H)) * 0.01
    sed[::5, ::7] = 0.0
    return dict(
        layers=np.stack([2.0 + 0.05 * np.cumsum(f(W, H), axis=0), sed]),
        uplift=u(W, H),
        discharge=np.abs(f(W, H)),
        mass=np.abs(f(W, H)) * 1e-3,
        momentum=f(2, W, H),
        debris=np.abs(f(W, H)) * 1e-2,
        debris_momentum=f(2, W, H),
        albedo_bedrock=u(3, W, H),
        albedo_fluvial=u(3, W, H) * 1.2,
        albedo_debris=u(3, W, H) * 1.2,
        albedo_surface=u(3, W, H),
    )


def test_godunov_gradient():
    h = _fields()["layers"].sum(axis=0)
    h[3, 4] = h[2, 4]  # a tie: backward wins
    got = port_erosion.godunov_gradient(_t(h), SCALE, 0.02)
    want = jax_erosion.godunov_gradient(jnp.asarray(h), SCALE, 0.02)
    _close(got, want)


def test_birth_density():
    got = port_erosion._birth_density(W, H)
    want = jax_erosion._birth_density(W, H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _directions(n):
    """Unit-ish direction components over the step rule's branch points:
    0, 1e-21 (tiny), 0.5/sqrt2 and 1/sqrt2 (the caps), 1, and random."""
    rng = np.random.default_rng(3)
    special = np.array([0.0, 1e-21, 0.5 / math.sqrt(2), 1 / math.sqrt(2),
                        1.0, 0.3535, 0.7072, 0.99], np.float32)
    a = rng.uniform(-1, 1, size=n).astype(np.float32)
    a[:len(special)] = special
    a[len(special):2 * len(special)] = -special
    return a


def test_stepsize_moments():
    vx = _directions(W * H).reshape(W, H)
    vy = np.roll(vx.ravel(), 17).reshape(W, H)
    for name in ("stepsize_center", "stepsize_expected", "stepsize_var"):
        got = getattr(port_transport, name)(_t(vx), _t(vy))
        want = getattr(jax_transport, name)(jnp.asarray(vx), jnp.asarray(vy))
        _close(got, want, name)


# (coefficient range, rtol). Across the expm1 series seam exp(x) - 1 is
# evaluated at |x| >= 0.01, where one ulp of exp is ~1e-5 of the result:
# the JAX package documents that bound (rel error <= 1.2e-5 at the branch
# point) and two exp implementations differ by it, in each of the two axis
# factors of the product: rtol 2.4e-5 there.
_COEFS = {
    "seam": ((-0.03, 0.03), 2.4e-5),
    "near-seam": ((0.0195, 0.0205), 2.4e-5),
    "clipped": ((-80.0, 80.0), 1e-6),
    "clip-edge": ((55.0, 58.0), 1e-6),
    "tiny-beta": ((-3e-12, 3e-12), 1e-6),
    "fluvial-decay": ((-1e4, 0.0), 1e-6),
}


@pytest.mark.parametrize("name", sorted(_COEFS))
def test_expected_exp_step(name):
    """Across the expm1 series seam (|beta u*/a| near 0.01), the +-40
    exponent clips, |beta| near 1e-12 and a -> 0."""
    (lo, hi), rtol = _COEFS[name]
    vx = _directions(W * H).reshape(W, H)
    vy = np.roll(vx.ravel(), 5).reshape(W, H)
    rng = np.random.default_rng(4)
    coef = rng.uniform(lo, hi, (W, H))
    if lo > 0:
        coef *= rng.choice([-1, 1], (W, H))
    coef = coef.astype(np.float32)
    got = port_transport.expected_exp_step(_t(vx), _t(vy), _t(coef))
    want = np.asarray(jax_transport.expected_exp_step(
        jnp.asarray(vx), jnp.asarray(vy), jnp.asarray(coef)))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=1e-6 * np.abs(want).max())


def _params(track_albedo):
    p = ErosionParams()
    p.trackAlbedo = track_albedo
    jp = JaxParams()
    for name, value in p.freeze():
        setattr(jp, name, value)
    return p, jp


@pytest.mark.parametrize("track_albedo", [True, False])
def test_mass_transfer(track_albedo):
    fl = _fields(1)
    p, jp = _params(track_albedo)
    names = ("layers", "uplift", "discharge", "mass", "momentum", "debris",
             "debris_momentum", "albedo_bedrock", "albedo_fluvial",
             "albedo_debris", "albedo_surface")
    delta = np.zeros((2, W, H), np.float32)
    got = port_erosion.mass_transfer(
        _t(delta), *[_t(fl[k]) for k in names], SCALE, p)
    want = jax_erosion.mass_transfer(
        jnp.asarray(delta), *[jnp.asarray(fl[k]) for k in names], SCALE, jp)
    _close(got[0], want[0], "delta")
    _close(got[1], want[1], "albedo")


def test_mass_creep():
    fl = _fields(2)
    p, jp = _params(True)
    rng = np.random.default_rng(5)
    delta = (rng.normal(size=(2, W, H)) * 1e-3).astype(np.float32)
    layers = fl["layers"].copy()
    layers[1] *= 50.0  # sediment deep enough for creep to move
    got = port_erosion.mass_creep(_t(delta), _t(layers), SCALE, p)
    want = jax_erosion.mass_creep(jnp.asarray(delta), jnp.asarray(layers),
                                  SCALE, jp)
    _close(got, want)
