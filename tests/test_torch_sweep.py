"""The PyTorch port's linear transport sweep (ops/sweep.py) and
`solve_uniform` against the JAX package on the CPU.

The port's plain rounds are held against the JAX Pallas sweep run in
interpret mode (`transport_sweep(..., interpret=True)`) at the JAX
package's own kernel bar, rtol 2e-6 / atol 1e-5 (tests/test_sweep.py),
on single- and multi-tile shapes of the TPU kernel. The checkpointed
reverse pass is held against `jax.grad` at rtol 1e-5. The CUDA kernel
itself is checked against these plain rounds on the card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.ops import sweep as jsweep
from soillib_tpu.ops import transport as jtransport
from soillib_tpu_torch.ops import sweep, transport

torch.set_num_threads(1)


def _problem(seed, C, W, H):
    """Seeded emissions, attenuations and unit directions, float32 numpy
    (the recipe of tests/test_sweep.py, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    E = np.abs(rng.normal(size=(C, W, H)))
    att = rng.uniform(0.3, 0.99, size=(C, W, H))
    d = rng.normal(size=(2, W, H))
    n = np.maximum(np.sqrt(d[0] ** 2 + d[1] ** 2), 1e-30)
    return [a.astype(np.float32) for a in (E, att, d[0] / n, d[1] / n)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, rtol=2e-6, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_push_matches_jax_bitwise():
    """One round, channel-first and channel-last, is the same arithmetic
    in the same order as the JAX package's."""
    E, att, vx, vy = _problem(3, 4, 40, 56)
    payload = att * E
    got = sweep.upwind_push_cf(*_t(payload, vx, vy))
    want = jsweep.upwind_push_cf(jnp.asarray(payload), jnp.asarray(vx),
                                 jnp.asarray(vy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dirs = np.stack([vx, vy], axis=-1)
    pl = np.moveaxis(payload, 0, -1).copy()
    got = transport.upwind_push(*_t(pl, dirs))
    want = jtransport.upwind_push(jnp.asarray(pl), jnp.asarray(dirs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("iters", [1, 8, 16, 23])
def test_sweep_matches_jax_kernel_single_tile(iters):
    """A grid smaller than one TPU kernel tile."""
    E, att, vx, vy = _problem(0, 3, 64, 80)
    want = jsweep.transport_sweep(*map(jnp.asarray, (E, att, vx, vy)), iters,
                                  interpret=True)
    got = sweep.transport_sweep_reference(*_t(E, att, vx, vy), iters)
    _close(got, want)


def test_sweep_matches_jax_kernel_multitile():
    """Several TPU kernel tiles in both dims + a remainder pass (19)."""
    E, att, vx, vy = _problem(1, 2, 420, 300)
    want = jsweep.transport_sweep(*map(jnp.asarray, (E, att, vx, vy)), 19,
                                  interpret=True)
    got = sweep.transport_advance_reference(
        torch.zeros((2, 420, 300)), *_t(E, att, vx, vy), 19)
    _close(got, want)


def test_advance_from_state_matches_jax():
    E, att, vx, vy = _problem(2, 2, 48, 40)
    G0 = np.abs(np.random.default_rng(9).normal(size=E.shape)).astype(
        np.float32)
    want = jsweep.transport_advance(*map(jnp.asarray, (G0, E, att, vx, vy)),
                                    5, interpret=True)
    got = sweep.transport_advance(*_t(G0, E, att, vx, vy), 5)
    _close(got, want)


def test_sweep_zero_flow_is_zero():
    """Dead cells (zero direction) neither emit nor receive."""
    E = torch.ones((1, 48, 48))
    att = torch.full((1, 48, 48), 0.9)
    z = torch.zeros((48, 48))
    got = sweep.transport_sweep(E, att, z, z, 8)
    assert bool((got == 0.0).all())


def test_sweep_outflow_lost_at_boundary():
    """Uniform +x flow: mass leaves the domain and never wraps around;
    the same as the JAX kernel."""
    E = np.ones((1, 40, 40), np.float32)
    att = np.ones((1, 40, 40), np.float32)
    vx, vy = np.ones((40, 40), np.float32), np.zeros((40, 40), np.float32)
    got = sweep.transport_sweep(*_t(E, att, vx, vy), 8).numpy()
    want = jsweep.transport_sweep(*map(jnp.asarray, (E, att, vx, vy)), 8,
                                  interpret=True)
    _close(got, want, rtol=1e-6, atol=0.0)
    # Row x receives the sum of E from rows x-8..x-1: row 0 gets nothing.
    assert got[0, 0].max() == 0.0
    np.testing.assert_allclose(got[0, -1], 8.0, rtol=1e-6)


def test_wide_channel_count_matches_jax():
    """C = 13, past the JAX kernel's VMEM cap of 12: the JAX package runs
    its plain rounds there; the port has no cap."""
    E, att, vx, vy = _problem(5, 13, 40, 40)
    want = jsweep.transport_advance(*map(jnp.asarray,
                                         (np.zeros_like(E), E, att, vx, vy)),
                                    9)
    got = sweep.run_transport(*_t(E, att, vx, vy), 9)
    _close(got, want)


def test_checkpointed_backward_matches_jax_grad():
    """The block-rematerialized reverse pass of the autograd Functions
    (forward on the CPU = the plain rounds) against jax.grad of the plain
    fixed point."""
    E, att, vx, vy = _problem(6, 3, 24, 24)
    G0 = np.abs(np.random.default_rng(7).normal(size=E.shape)).astype(
        np.float32)
    jE, jatt, jvx, jvy, jG0 = map(jnp.asarray, (E, att, vx, vy, G0))
    want = jax.grad(lambda e, a, x, y: jsweep.transport_sweep_reference(
        e, a, x, y, 37).sum(), argnums=(0, 1, 2, 3))(jE, jatt, jvx, jvy)
    ins = [t.requires_grad_(True) for t in _t(E, att, vx, vy)]
    sweep.DiffableSweep.apply(*ins, 37).sum().backward()
    for t, w in zip(ins, want):
        _close(t.grad, w, rtol=1e-5, atol=1e-5)

    want = jax.grad(lambda g, e: jsweep.transport_advance_reference(
        g, e, jatt, jvx, jvy, 21).sum(), argnums=(0, 1))(jG0, jE)
    g0, e = [t.requires_grad_(True) for t in _t(G0, E)]
    sweep.DiffableAdvance.apply(g0, e, *_t(att, vx, vy), 21).sum().backward()
    _close(g0.grad, want[0], rtol=1e-5, atol=1e-5)
    _close(e.grad, want[1], rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_rounds():
    """No launch on CPU tensors; the kernel wrapper refuses them."""
    E, att, vx, vy = _t(*_problem(8, 1, 16, 12))
    before = dict(sweep.sweep_launches)
    sweep.run_transport(E, att, vx, vy, 4)
    assert sweep.sweep_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        sweep.transport_advance_cuda(torch.zeros_like(E), E, att, vx, vy, 1)


def _flow_problem(seed, W, H):
    rng = np.random.default_rng(seed)
    h = np.cumsum(np.cumsum(rng.normal(size=(W, H)), 0), 1).astype(
        np.float32)
    g = np.asarray(jsoil.gradient(h, (2.0, 3.0)))
    flow = (-g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True),
                            1e-6)).astype(np.float32)
    flow[::7, ::5] = 0.0  # dead cells
    return flow, rng


@pytest.mark.parametrize("channels", [0, 2])
def test_solve_uniform_matches_jax(channels):
    """(W, H) and (W, H, 2) sources, default W+H rounds."""
    flow, rng = _flow_problem(11, 50, 36)
    shape = (50, 36) if channels == 0 else (50, 36, channels)
    source = rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
    decay = rng.uniform(0.0, 0.01, size=(50, 36)).astype(np.float32)
    want = np.asarray(jsoil.solve_uniform(flow, source, decay, (2.0, 3.0)))
    got = soil.solve_uniform(flow, source, decay, (2.0, 3.0),
                             device="cpu").numpy()
    _close(got, want, atol=1e-5 * np.abs(want).max())


def test_solve_uniform_layout_and_method_errors():
    flow, _ = _flow_problem(12, 8, 8)
    ones = np.ones((8, 8), np.float32)
    with pytest.raises(ValueError, match="channel-LAST"):
        soil.solve_uniform(np.moveaxis(flow, -1, 0), ones, ones,
                           device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        soil.solve_uniform(flow, ones, ones, method="walkers", device="cpu")


def test_particles_refuse_a_sharded_halo():
    """The particle estimators are single-device, as in the JAX package:
    any halo but NO_HALO raises."""
    flow, _ = _flow_problem(12, 8, 8)
    ones = np.ones((8, 8), np.float32)
    with pytest.raises(NotImplementedError, match="single-device"):
        soil.solve_uniform(flow, ones, ones, method="particles",
                           halo=object(), device="cpu")
    p = soil.ErosionParams()
    p.transportMethod = "particles"
    st = soil.ErosionState.zeros((8, 8), device="cpu")
    with pytest.raises(NotImplementedError, match="sharded halo"):
        soil.transport_debris(st.layers, st.debris, st.debris_momentum,
                              st.albedo_surface, (0.1, 0.1, 4.0), p,
                              halo=object())


def test_stepsize_matches_jax():
    """The DDA step, NaN-skipping fmin/fmax included (positions on lattice
    lines with zero direction components)."""
    rng = np.random.default_rng(13)
    pos = rng.uniform(0, 20, size=(500, 2)).astype(np.float32)
    pos[:50] = np.floor(pos[:50])
    d = rng.normal(size=(500, 2))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:25, 0] = 0.0
    d[25:50, 1] = 0.0
    got = transport.stepsize(*_t(pos, d)).numpy()
    want = np.asarray(jtransport.stepsize(jnp.asarray(pos), jnp.asarray(d)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
