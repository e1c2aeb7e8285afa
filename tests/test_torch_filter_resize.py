"""The port's `gaussian_blur`, `resize` and `copy` against the JAX package
on the CPU, at rtol 2e-6 / atol 1e-6 (XLA may contract a multiply-add of
the taps or the bilinear weights into one FMA)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil

torch.set_num_threads(1)


def _close(got, want):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-6)


def _field(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(37, 23), (20, 26, 3)])
@pytest.mark.parametrize("sigma", [0.5, 2.0, 12.0])
def test_gaussian_blur_matches_jax(shape, sigma):
    a = _field(shape, 1)
    got = soil.gaussian_blur(torch.from_numpy(a), sigma)
    assert got.shape == a.shape
    _close(got, jsoil.gaussian_blur(jnp.asarray(a), sigma))


def test_gaussian_blur_loses_mass_past_the_window():
    """sigma = 12 truncates the 33-tap kernel without renormalising it
    (filter.cu:47-48): a constant field comes out darker."""
    a = np.ones((40, 40), np.float32)
    out = soil.gaussian_blur(a, 12.0, device="cpu")
    assert float(out.max()) < 0.9


@pytest.mark.parametrize("shape", [(37, 23), (16, 16, 3)])
@pytest.mark.parametrize("newres", [(64, 50), (10, 7), (37, 23), (1, 5)])
def test_resize_matches_jax(shape, newres):
    a = _field(shape, 2)
    got = soil.resize(torch.from_numpy(a), newres)
    assert tuple(got.shape) == tuple(newres) + tuple(shape[2:])
    _close(got, jsoil.resize(jnp.asarray(a), newres))


def test_copy_matches_jax():
    """Two offset tiles blitted into a NaN raster at a pixel scale of 1.3,
    the first with a NaN hole (the destination keeps its value there)."""
    rng = np.random.default_rng(3)
    tiles = [(rng.random((30, 20)).astype(np.float32) * 40.0,
              (3.3, 1.7)),
             (rng.random((25, 25)).astype(np.float32) * 40.0,
              (33.3, 10.2))]
    tiles[0][0][3:6, 4] = np.nan
    wmin, wmax = np.array([0.0, 0.0]), np.array([60.0, 40.0])
    wscale = np.array([1.0, 1.0])
    got = torch.full((78, 52), float("nan"))
    want = jnp.full((78, 52), jnp.nan)
    for src, (ox, oy) in tiles:
        kw = dict(gmin=np.array([ox, oy]),
                  gmax=np.array([ox, oy]) + src.shape,
                  gscale=np.array([1.0, 1.0]), wmin=wmin, wmax=wmax,
                  wscale=wscale, pscale=1.3)
        got = soil.copy(got, torch.from_numpy(src), **kw)
        want = jsoil.copy(want, jnp.asarray(src), **kw)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert 0 < int(np.isnan(want).sum()) < want.size
    _close(got, want)
