"""The PyTorch port's DEM operations — flow graphs, accumulation, the tiled
scheme's phases, depression filling and the stencils — against the JAX
package on the CPU.

Receiver graphs, slots, slopes, fills and the tiled phases are compared
bitwise: the same arithmetic in the same order. Accumulations by every
method are held against the JAX package's tiled scheme with its Pallas
tile solver in interpret mode, at rtol 1e-5 (the JAX package's own bar,
tests/test_graph_tiled_pallas.py): scatter-add and pointer-doubling sum in
another order. Shapes past one 128² tile and ragged ones are used.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.ops import graph as jgraph
from soillib_tpu.ops import graph_tiled as jtiled
from soillib_tpu_torch.ops import graph, graph_tiled

torch.set_num_threads(1)

D4, D8 = soil.D4, soil.D8
SHAPE = (300, 260)  # 3 x 3 tiles, both edges ragged


def _dem(shape=SHAPE, seed=3):
    """Seeded noise terrain with jitter, filled by the JAX package."""
    rng = np.random.default_rng(seed)
    h = np.asarray(jsoil.noise(shape, jsoil.noise_t(seed=float(seed)))) * 50
    h = (h + 0.01 * rng.normal(size=shape)).astype(np.float32)
    return np.array(jsoil.fill_depressions(h))


@pytest.fixture(scope="module")
def dem():
    return _dem()


@pytest.fixture(scope="module")
def graphs(dem):
    return {e: np.array(jsoil.steepest(dem, e)) for e in (D4, D8)}


@pytest.mark.parametrize("edge", [D4, D8])
def test_flow_graphs_bitwise(dem, graphs, edge):
    """steepest, direction, slope, graph_to_slots."""
    got = soil.steepest(dem, edge, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), graphs[edge])
    np.testing.assert_array_equal(
        soil.direction(dem, edge, device="cpu").numpy(),
        np.asarray(jsoil.direction(dem, edge)))
    np.testing.assert_array_equal(
        soil.slope(dem, graphs[edge], (2.0, 3.0), device="cpu").numpy(),
        np.asarray(jsoil.slope(dem, graphs[edge], (2.0, 3.0))))
    np.testing.assert_array_equal(
        graph.graph_to_slots(torch.from_numpy(graphs[edge]), edge).numpy(),
        np.asarray(jgraph.graph_to_slots(jnp.asarray(graphs[edge]), edge)))


@pytest.mark.parametrize("edge", [D4, D8])
@pytest.mark.parametrize("T", [1.0, 0.05])
def test_random_weighted_bitwise_with_jax_uniforms(dem, edge, T):
    u = np.random.default_rng(21).uniform(size=dem.shape).astype(np.float32)
    want = np.asarray(jsoil.random_weighted(dem, edge, T=T,
                                            u=jnp.asarray(u)))
    got = soil.random_weighted(dem, edge, T=T, u=u, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_weighted_generator_is_deterministic(dem):
    a = soil.random_weighted(dem, D8, seed=4, offset=2, device="cpu")
    b = soil.random_weighted(dem, D8, seed=4, offset=2, device="cpu")
    c = soil.random_weighted(dem, D8, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    # Every sampled receiver is a downhill neighbor, as in the JAX package.
    h = torch.from_numpy(dem).reshape(-1)
    for g in (a, c):
        f = g.reshape(-1)
        live = f >= 0
        assert bool((h[f[live].long()] < h[live]).all())


@pytest.mark.parametrize("edge", [D4, D8])
@pytest.mark.parametrize("decay", [0.9, 0.9999])
def test_edge_weights_bitwise(graphs, edge, decay):
    """The compacted-slot decay^1.414 quirk, for the scalar decays the DEM
    workloads use."""
    g = graphs[edge]
    want = np.asarray(jgraph._edge_weights(jnp.asarray(g), decay, edge))
    got = graph._edge_weights(torch.from_numpy(g), decay, edge).numpy()
    np.testing.assert_array_equal(got, want)


def test_edge_weights_field_decay(graphs):
    """A per-cell decay field: the exponent lands on the same cells; where
    it does, torch's and XLA's float32 pow may differ in the last bit."""
    g = graphs[D8]
    d = np.random.default_rng(2).uniform(0.5, 1.0, g.shape).astype(
        np.float32)
    want = np.asarray(jgraph._edge_weights(jnp.asarray(g), d, D8))
    got = graph._edge_weights(torch.from_numpy(g), torch.from_numpy(d),
                              D8).numpy()
    np.testing.assert_array_equal(got == d, want == d)
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0.0)


def _jax_tiled(g, edge, decay=None):
    slots = jgraph.graph_to_slots(jnp.asarray(g), edge)
    w = None if decay is None else jgraph._edge_weights(jnp.asarray(g),
                                                        decay, edge)
    return np.asarray(jtiled.accumulate_tiled(
        slots, jnp.ones(g.shape, jnp.float32), w, edge,
        tile_solver="pallas"))


@pytest.mark.parametrize("edge", [D4, D8])
def test_accumulate_all_methods_match_jax(graphs, edge):
    want = _jax_tiled(graphs[edge], edge)
    for method in ("doubling", "stencil", "tiled"):
        got = soil.accumulate(graphs[edge], 1.0, edge, method=method,
                              device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=method)
    # The CPU default is pointer doubling, as in the JAX package.
    assert graph._auto_method(None, torch.from_numpy(graphs[edge])) \
        == "doubling"


@pytest.mark.parametrize("edge", [D4, D8])
def test_accumulate_decay_all_methods_match_jax(graphs, edge):
    want = _jax_tiled(graphs[edge], edge, 0.9)
    rain = np.ones(graphs[edge].shape, np.float32)
    for method in ("doubling", "stencil", "tiled"):
        got = soil.accumulate_decay(graphs[edge], rain, 0.9, edge,
                                    method=method, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=method)


@pytest.mark.parametrize("edge", [D4, D8])
def test_tile_phases_bitwise_vs_jax_tile_kernels(graphs, edge):
    """The plain versions of the port's tile kernels (full-grid fixed
    points) against the JAX package's Pallas tile kernels (interpret
    mode) on the same inputs: phase 1's local push and phase 2's trace."""
    g = graphs[edge]
    W, H = g.shape
    w_np = np.array(jgraph._edge_weights(jnp.asarray(g), 0.9, edge))
    src_np = np.random.default_rng(5).uniform(0.5, 2.0, g.shape).astype(
        np.float32)
    jslot = jgraph.graph_to_slots(jnp.asarray(g), edge)
    jlslot, jcross = jtiled._local_slot(W, H, jslot, edge)
    jrecv = jtiled._pull(jnp.arange(W * H, dtype=jnp.int32).reshape(W, H),
                         jslot, edge, 0)
    iters = jtiled.TILE ** 2

    slot = graph.graph_to_slots(torch.from_numpy(g), edge)
    lslot, cross = graph_tiled._local_slot(W, H, slot, edge)
    np.testing.assert_array_equal(lslot.numpy(), np.asarray(jlslot))
    np.testing.assert_array_equal(cross.numpy(), np.asarray(jcross))
    recv = graph_tiled._pull(
        torch.arange(W * H, dtype=torch.int32).reshape(W, H), slot, edge, 0)
    np.testing.assert_array_equal(recv.numpy(), np.asarray(jrecv))

    want = jtiled._local_fp_pallas(jlslot, jnp.asarray(src_np),
                                   jnp.asarray(w_np), edge, iters, True)
    got = graph_tiled.local_fp_plain(lslot, torch.from_numpy(src_np),
                                     torch.from_numpy(w_np), edge, iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jX, jD = jtiled._trace_pallas(jslot, jcross, jrecv, jnp.asarray(w_np),
                                  edge, iters, True)
    X, D = graph_tiled.trace_plain(slot, cross, recv,
                                   torch.from_numpy(w_np), edge, iters)
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(D.numpy(), np.asarray(jD))


@pytest.mark.parametrize("shape", [(2 * 128, 128 + 56), (128 + 1, 3 * 128),
                                   (300, 200)])
def test_boundary_rank_matches_sort_form(shape):
    """The closed-form rank against the JAX package's sort +
    searchsorted form, on every boundary cell and on -1 fallbacks."""
    W, H = shape
    bidx = graph_tiled._boundary_indices(W, H)
    np.testing.assert_array_equal(bidx, jtiled._boundary_indices(W, H))
    K = bidx.shape[0]
    rng = np.random.default_rng(3)
    q = bidx[rng.permutation(K)]
    q[::7] = -1
    fb = np.arange(K, dtype=np.int32)
    want = jgraph.compact_index(jnp.asarray(bidx), jnp.asarray(q),
                                jnp.asarray(fb))
    got = graph_tiled._boundary_rank(W, H, torch.from_numpy(q),
                                     torch.from_numpy(fb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accumulate_single_tile_and_chain():
    """A grid within one tile (the stencil shortcut) and a single chain:
    exact counts."""
    n = 50
    g = np.arange(1, n + 1, dtype=np.int32).reshape(1, n) % n
    g[0, -1] = -1  # a 1 x 50 chain draining to its last cell
    got = soil.accumulate(g, 1.0, D4, method="tiled", device="cpu")
    np.testing.assert_array_equal(got.numpy()[0], np.arange(1, n + 1))


def test_accumulate_reverse_differentiable(graphs):
    """Pointer doubling carries gradients: d(sum of accumulate)/d(rain)
    equals the JAX package's."""
    g = graphs[D8]
    rain = torch.ones(g.shape, requires_grad=True)
    soil.accumulate_decay(g, rain, 0.9, D8, method="doubling",
                          device="cpu").sum().backward()
    import jax

    want = jax.grad(lambda r: jsoil.accumulate_decay(
        g, r, 0.9, D8, method="doubling").sum())(jnp.ones(g.shape))
    np.testing.assert_allclose(rain.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("edge", [D4, D8])
def test_fill_depressions_matches_jax(edge):
    """Bitwise, NaN holes included (they drain like boundaries)."""
    rng = np.random.default_rng(8)
    h = np.asarray(jsoil.noise((90, 70), jsoil.noise_t(seed=8.0))) * 30
    h = (h + 0.05 * rng.normal(size=h.shape)).astype(np.float32)
    h[40:44, 30:33] = np.nan
    h[0, 5] = np.nan
    want = np.asarray(jsoil.fill_depressions(h, edge))
    got = soil.fill_depressions(h, edge, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~np.isnan(h)] >= h[~np.isnan(h)]).all()
    np.testing.assert_array_equal(
        soil.condition(h, edge, device="cpu").numpy(), want)


def test_stencils_match_jax():
    rng = np.random.default_rng(4)
    h = rng.normal(size=(33, 27)).astype(np.float32)
    h[3, 4] = np.nan
    for name in ("gradient", "laplacian"):
        got = getattr(soil, name)(h, (0.5, 2.0), device="cpu").numpy()
        want = np.asarray(getattr(jsoil, name)(h, (0.5, 2.0)))
        np.testing.assert_array_equal(got, want, err_msg=name)
    # XLA may contract gx*gx + gy*gy into one fused multiply-add: an ulp.
    np.testing.assert_allclose(
        soil.negslope(h, (0.5, 2.0), device="cpu").numpy(),
        np.asarray(jsoil.negslope(h, (0.5, 2.0))), rtol=2.4e-7, atol=0.0)
    h2 = rng.normal(size=(33, 27, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        soil.laplacian(h2, (0.5, 2.0), device="cpu").numpy(),
        np.asarray(jsoil.laplacian(h2, (0.5, 2.0))))
    np.testing.assert_allclose(
        soil.normal(h[5:], (0.5, 2.0, 3.0), device="cpu").numpy(),
        np.asarray(jsoil.normal(h[5:], (0.5, 2.0, 3.0))),
        rtol=2e-6, atol=1e-7)


def test_tile_kernel_wrappers_refuse_cpu_tensors():
    slot = torch.full((8, 8), -1, dtype=torch.int32)
    w = torch.ones((8, 8))
    before = dict(graph_tiled.tile_launches)
    with pytest.raises(ValueError, match="CUDA"):
        graph_tiled.local_fp_cuda(slot, w, w, D8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        graph_tiled.trace_cuda(slot, w, D8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        graph_tiled.accumulate_tiled(
            torch.full((200, 200), -1, dtype=torch.int32),
            torch.ones((200, 200)), tile_solver="cuda")
    assert graph_tiled.tile_launches == before
