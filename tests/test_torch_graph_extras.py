"""The port's `compact_index`, `upstream_mask` and `upstream_distance`
against the JAX package on the CPU, bitwise: receiver graphs from
`steepest` on seeded terrain, with NaN holes, a self-loop root and a
1 x 1 grid."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.ops.graph import compact_index as jax_compact_index
from soillib_tpu_torch.ops.graph import compact_index

torch.set_num_threads(1)


def _terrain(W, H, seed, holes=False):
    rng = np.random.default_rng(seed)
    h = np.cumsum(np.cumsum(rng.normal(size=(W, H)), axis=0), axis=1)
    h = (h + 5.0 * rng.normal(size=(W, H))).astype(np.float32)
    if holes:
        h[rng.random((W, H)) < 0.08] = np.nan
        h[W // 3: W // 3 + 4, H // 2: H // 2 + 3] = np.nan
    return h


CASES = [((33, 21), 0, False), ((40, 40), 1, True), ((17, 5), 2, False),
         "self-loop", "1x1"]
IDS = ["33x21", "40x40-holes", "17x5", "self-loop", "1x1"]


@functools.lru_cache(maxsize=None)
def _graph(case):
    """The case's receiver graph (JAX's steepest), built on first use."""
    if case == "1x1":
        return np.full((1, 1), -1, np.int32)
    if case == "self-loop":
        g = _graph(CASES[0]).copy()
        g.reshape(-1)[100] = 100          # a self-loop root
        g.reshape(-1)[101] = 100
        return g
    (W, H), seed, holes = case
    return np.array(jsoil.steepest(_terrain(W, H, seed, holes), jsoil.d8))


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == {np.dtype(bool): torch.bool,
                         np.dtype(np.int32): torch.int32}[want.dtype]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_upstream_distance_matches_jax(case):
    g = _graph(case)
    got = soil.upstream_distance(torch.from_numpy(g))
    _same(got, jsoil.upstream_distance(jnp.asarray(g)))
    # Numpy input goes to the device asked for.
    _same(soil.upstream_distance(g, device="cpu"),
          jsoil.upstream_distance(jnp.asarray(g)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_upstream_mask_matches_jax(case):
    g = _graph(case)
    rng = np.random.default_rng(g.size)
    for frac in (0.0, 0.01, 0.2):
        targets = rng.random(g.shape) < frac
        if frac == 0.01:
            targets.reshape(-1)[0] = True
        got = soil.upstream_mask(torch.from_numpy(g),
                                 torch.from_numpy(targets))
        _same(got, jsoil.upstream_mask(jnp.asarray(g),
                                       jnp.asarray(targets)))


@pytest.mark.parametrize("n_ids", [1, 7, 300])
def test_compact_index_matches_jax(n_ids):
    rng = np.random.default_rng(n_ids)
    ids = rng.permutation(4 * n_ids + 10)[:n_ids].astype(np.int32)
    queries = np.concatenate([
        rng.choice(ids, 40),                                   # hits
        rng.integers(-5, 4 * n_ids + 15, 40),                  # any
        [-1, -7, int(ids.max()) + 1, int(ids.min())],
    ]).astype(np.int32)
    fallbacks = (-1, rng.integers(0, 9, queries.shape).astype(np.int32))
    for fb in fallbacks:
        got = compact_index(torch.from_numpy(ids), torch.from_numpy(queries),
                            torch.as_tensor(fb) if not isinstance(fb, int)
                            else fb)
        _same(got, jax_compact_index(jnp.asarray(ids), jnp.asarray(queries),
                                     jnp.asarray(fb)))


def test_boundary_set_is_built_once_per_shape_and_device():
    """The tiled accumulation's boundary set (the JAX package's trace-time
    constant) is one tensor per (W, H, device), bitwise the numpy set,
    also at sizes that are not a multiple of the tile."""
    from soillib_tpu.ops import graph_tiled as jtiled
    from soillib_tpu_torch.ops import graph_tiled

    cpu = torch.device("cpu")
    for W, H in ((1000, 744), (300, 260), (129, 5)):
        a = graph_tiled._boundary_index_tensor(W, H, cpu)
        assert graph_tiled._boundary_index_tensor(W, H, cpu) is a
        assert a.dtype == torch.int64 and a.device == cpu
        np.testing.assert_array_equal(a.numpy(),
                                      jtiled._boundary_indices(W, H))
    assert graph_tiled._boundary_index_tensor(1000, 744, cpu) is not \
        graph_tiled._boundary_index_tensor(744, 1000, cpu)
