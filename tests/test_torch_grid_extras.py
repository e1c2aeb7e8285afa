"""The port's grid helpers (`Shape`, `flatten`, `unflatten`, `oob`), Morton
codes and per-step metrics against the JAX package on the CPU: the index
outputs bitwise, the metrics at rtol 2e-5 (reductions over a grid in
another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.core import morton as jmorton
from soillib_tpu_torch.convert import state_from_numpy
from soillib_tpu_torch.core import grid, morton

torch.set_num_threads(1)


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dims", [(7, 5), (1, 1), (64, 3, 4)])
def test_flatten_unflatten_oob_match_jax(dims):
    rng = np.random.default_rng(sum(dims))
    pos = rng.integers(-3, max(dims[:2]) + 3, size=(50, 2)).astype(np.int32)
    flat = rng.integers(-2 * dims[1] - 5, dims[0] * dims[1] + 5,
                        size=50).astype(np.int32)
    flat[:3] = [-1, -dims[1], -dims[1] - 1]   # negative: floor division
    _same(grid.flatten(pos, dims, device="cpu"), jsoil.flatten(pos, dims))
    _same(grid.unflatten(flat, dims, device="cpu"),
          jsoil.unflatten(flat, dims))
    _same(grid.oob(pos, dims, device="cpu"), jsoil.oob(pos, dims))
    # Float positions truncate toward zero, as astype(int32) does.
    fpos = rng.uniform(-2.0, 8.0, size=(20, 2)).astype(np.float32)
    _same(grid.flatten(fpos, dims, device="cpu"), jsoil.flatten(fpos, dims))


def test_shape_matches_jax():
    s, js = soil.Shape(64, 3, 4), jsoil.Shape((64, 3, 4))
    assert (s.dims, s.dim(), s.elem(), s.W, s.H, len(s), list(s)) == \
        (js.dims, js.dim(), js.elem(), js.W, js.H, len(js), list(js))
    assert soil.Shape([5, 6]) == soil.Shape(5, 6)
    pos = np.array([[0, 0], [63, 2], [64, 0], [-1, 1]], np.int32)
    _same(s.flatten(pos, device="cpu"), js.flatten(pos))
    _same(s.unflatten(np.array([0, 5, -4, 191], np.int32), device="cpu"),
          js.unflatten(np.array([0, 5, -4, 191], np.int32)))
    _same(s.oob(pos, device="cpu"), js.oob(pos))
    t = torch.zeros((4, 9, 2))
    assert grid.spatial_shape(t) == (4, 9)


def test_grid_helpers_keep_tensors_on_their_device():
    t = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    out = soil.flatten(t, (8, 8))     # no device= needed for a tensor
    assert out.device == t.device and out.tolist() == [10, 28]


def test_morton_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 16, 2000).astype(np.int32)
    y = rng.integers(0, 1 << 16, 2000).astype(np.int32)
    x[:4] = [0, 0xFFFF, 0, 0xFFFF]
    y[:4] = [0, 0xFFFF, 0xFFFF, 0]
    code = morton.encode2(x, y, device="cpu")
    assert code.dtype == torch.uint32
    want = np.asarray(jmorton.encode2(x, y))
    np.testing.assert_array_equal(code.numpy(), want)
    for got, ref in zip(morton.decode2(code), jmorton.decode2(want)):
        _same(got, ref)
    # Round trip, and arbitrary 32-bit codes decoded as JAX decodes them.
    dx, dy = morton.decode2(code)
    np.testing.assert_array_equal(dx.numpy(), x)
    np.testing.assert_array_equal(dy.numpy(), y)
    raw = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    for got, ref in zip(morton.decode2(raw, device="cpu"),
                        jmorton.decode2(raw)):
        _same(got, ref)


def test_metrics_summarize_matches_jax():
    rng = np.random.default_rng(5)
    W, H = 40, 36
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    bed = 2.0 + 0.01 * np.cumsum(np.cumsum(f(W, H), axis=0), axis=1)
    fields = dict(
        layers=np.stack([bed, np.abs(f(W, H)) * 0.01]),
        rainfall=np.ones((W, H), np.float32), uplift=np.abs(f(W, H)),
        discharge=np.abs(f(W, H)), mass=np.abs(f(W, H)) * 1e-3,
        momentum=f(2, W, H), debris=np.abs(f(W, H)) * 1e-3,
        debris_momentum=f(2, W, H),
        **{k: np.abs(f(3, W, H)) for k in (
            "albedo_bedrock", "albedo_surface", "albedo_fluvial",
            "albedo_debris")})
    scale = (0.1, 0.2, 4.0)
    got = soil.metrics.summarize(state_from_numpy(fields, "cpu"), scale)
    jstate = jsoil.ErosionState(**{k: jnp.asarray(v)
                                   for k, v in fields.items()})
    want = jsoil.metrics.summarize(jstate, scale)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dim() == 0 and v.device.type == "cpu", k
        np.testing.assert_allclose(float(v), float(want[k]), rtol=2e-5,
                                   err_msg=k)
    assert soil.metrics.throughput(100, 4, 2.0) == \
        jsoil.metrics.throughput(100, 4, 2.0)
