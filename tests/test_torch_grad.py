"""Reverse mode of the PyTorch port against the JAX package, on the CPU.

The coupled step's gradient is held to `jax.grad`'s VALUES (the twin of
tests/test_checkpoint.py::test_erosion_step_is_differentiable), and the
cohort solve stays differentiable for every closure the port has (the
twin of tests/test_grad_closures.py). On the card the solves go through
autograd Functions whose forward is the kernel and whose backward is the
plain path (`DiffableCohort`, `DiffableTiledAccumulate`); here the kernel
wrappers are replaced by their plain versions on CPU tensors, so the
Functions' plumbing (the rounds replayed, the cotangents returned) is
held against the plain path's own autograd gradient. The kernels' side
runs in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.models.simulation import erode_step as jax_erode_step
from soillib_tpu_torch.models.erosion import make_fluvial_rules
from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.models.simulation import erode_step
from soillib_tpu_torch.ops import cohort, graph
from soillib_tpu_torch.ops import graph_tiled as gt
from tests.test_torch_cohort_schedule import PlainLaunches
from tests.test_torch_cuda import CLOSURES as CUDA_CLOSURES
from tests.test_torch_cuda import (
    LLEN,
    TOL,
    band_problem,
    cohort_arrays,
    port_rules,
)

torch.set_num_threads(1)

SCALE = (0.1, 0.1, 2.0)


def _step_loss_grads(h0):
    """(port gradient, JAX gradient) of sum(discharge^2) + sum(height^2)
    after one default coupled step at 4 transport rounds, w.r.t. the
    initial terrain."""
    p = soil.ErosionParams()
    p.transportIterations = 4
    jp = jsoil.ErosionParams()
    jp.transportIterations = 4
    W, H = h0.shape

    h = torch.from_numpy(h0).requires_grad_(True)
    out = erode_step(soil.ErosionState.zeros((W, H), height=h, device="cpu"),
                     SCALE, p)
    loss = torch.sum(out.discharge ** 2) + torch.sum(out.height ** 2)
    (g,) = torch.autograd.grad(loss, h)

    def jloss(height):
        st = jsoil.ErosionState.zeros((W, H), height=height)
        o = jax_erode_step(st, SCALE, jp, jax.random.PRNGKey(1))
        return jnp.sum(o.discharge ** 2) + jnp.sum(o.height ** 2)

    # Eagerly, as tests/test_grad_closures.py runs it: XLA's reverse-mode
    # compile of the cohort round takes minutes on the CPU, and the values
    # are what is compared.
    with jax.disable_jit():
        gj = jax.grad(jloss)(jnp.asarray(h0))
    return g.numpy(), np.asarray(gj)


def test_erosion_step_grad_matches_jax():
    """The port's autograd gradient of the coupled step equals jax.grad's
    values at rtol 1e-4 with an absolute floor of 1e-5 of the gradient's
    scale: reverse mode through 4 nonlinear cohort rounds and the
    transfer/creep glue sums in another order than XLA's (the forward
    step's own bar is rtol 2e-5, tests/test_torch_erosion.py)."""
    rng = np.random.default_rng(0)
    h0 = (1.0 + 0.2 * rng.normal(size=(16, 16))).astype(np.float32)
    got, want = _step_loss_grads(h0)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


# Every closure of tests/test_grad_closures.py; the first three keep the
# ids they had before the other variants were ported.
CLOSURES = {name: CUDA_CLOSURES[name] for name in (
    "default", "nodes2", "nodes4", "legacy", "offstep-off", "stream",
    "all-on", "sign", "cluster", "speed")}


@pytest.mark.parametrize("closure", list(CLOSURES.values()),
                         ids=list(CLOSURES))
def test_cohort_grad_finite_for_every_ported_closure(closure):
    """The port's twin of tests/test_grad_closures.py for the closures it
    has: the gradient of sum(G^2) after 4 rounds with the real fluvial
    rules w.r.t. the velocity field is finite and nonzero on a state
    with exact zeros."""
    rules = make_fluvial_rules(ErosionParams(), 0.1)
    v = (0.4 * torch.ones((12, 12))).requires_grad_(True)
    st, aux = band_problem(closure, v)
    G = cohort.run_cohort(st, aux, rules, 4, 0.1, closure)
    (g,) = torch.autograd.grad(torch.sum(G ** 2), v)
    assert torch.isfinite(g).all(), f"non-finite gradient for {closure}"
    assert float(g.abs().max()) > 0.0


def _plain_grads(st, aux, rules, rounds, closure):
    s = st.clone().requires_grad_(True)
    a = aux.clone().requires_grad_(True)
    _, G = cohort.cohort_advance_reference(s, a, rules, rounds, LLEN,
                                           closure=closure)
    return torch.autograd.grad(torch.sum(G * G), (s, a))


@pytest.mark.parametrize("closure,iters", [
    (None, 37), (soil.CohortClosure(nodes=4), 5),
    (soil.CohortClosure(colors=2), 6)])
def test_diffable_cohort_backward_is_the_plain_rounds(monkeypatch, closure,
                                                      iters):
    """`DiffableCohort` (the kernel's forward, here the plain rounds
    standing in for the launches) returns the plain solve's gradient for
    the state and aux, bitwise: its backward replays the same rounds,
    checkpointed per block of 16."""
    cl = closure or soil.CohortClosure()
    groups = int(cl.colors) * int(cl.nodes)
    sts = [cohort_arrays("fluvial", True, 20, 18, seed=j)
           for j in range(groups)]
    st = torch.from_numpy(np.concatenate([s for s, _ in sts]))
    aux = torch.from_numpy(sts[0][1])
    tr = port_rules("fluvial", True, 20, 18)
    monkeypatch.setattr(cohort, "cohort_rounds_cuda", PlainLaunches())
    s = st.clone().requires_grad_(True)
    a = aux.clone().requires_grad_(True)
    G = cohort.DiffableCohort.apply(s, a, tr, iters, LLEN, closure, 0.0)
    got = torch.autograd.grad(torch.sum(G * G), (s, a))
    want = _plain_grads(st, aux, tr, iters, closure)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_diffable_cohort_replays_the_rounds_the_kernel_ran(monkeypatch):
    """With `tol` the kernel path stops at a 16-round check, past the
    plain exit round: the backward replays the rounds it ran, so the
    gradient is the plain fixed-depth solve's at that depth."""
    p = ErosionParams()
    p.evapRate = 50.0
    p.depositionRateFluvial = 50.0
    st, aux = cohort_arrays("fluvial", True, 48, 40, seed=3, aux3_scale=50.0)
    st, aux = torch.from_numpy(st), torch.from_numpy(aux)
    tr = port_rules("fluvial", True, 48, 40, p)
    iters = 88
    fake = PlainLaunches()
    monkeypatch.setattr(cohort, "cohort_rounds_cuda", fake)
    s = st.clone().requires_grad_(True)
    a = aux.clone().requires_grad_(True)
    G = cohort.DiffableCohort.apply(s, a, tr, iters, LLEN, None, TOL)
    ran = sum(r for r, _ in fake.calls)
    assert 0 < ran < iters and ran % cohort.TOL_CHECK_ROUNDS == 0
    got = torch.autograd.grad(torch.sum(G * G), (s, a))
    want = _plain_grads(st, aux, tr, ran, None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _plain_tile_launches(monkeypatch):
    """Replaces the tile kernels' wrappers with the plain fixed points on
    CPU tensors (same returns, the per-tile rounds left empty)."""
    def local(lslot, src, w, edge, max_iters):
        return gt.local_fp_plain(lslot, src, w, edge, max_iters), None

    def trace(slot, w, edge, max_iters):
        W, H = slot.shape
        _, cross = gt._local_slot(W, H, slot, edge)
        n = torch.arange(W * H, dtype=torch.int32).reshape(W, H)
        recv = gt._pull(n, slot, edge, 0)
        return (*gt.trace_plain(slot, cross, recv, w, edge, max_iters), None)

    monkeypatch.setattr(gt, "local_fp_cuda", local)
    monkeypatch.setattr(gt, "trace_cuda", trace)


@pytest.mark.parametrize("W,H", [(300, 260), (90, 70)])
def test_diffable_tiled_accumulate_backward(monkeypatch, W, H):
    """`accumulate_tiled` through the kernel solver (plain fixed points
    standing in) carries a graph; its gradients w.r.t. the value and a
    decay tensor are pointer doubling's, the form it differentiates,
    bitwise; and they equal the plain tiled solver's own autograd
    gradient at rtol 1e-5 (another summation order)."""
    _plain_tile_launches(monkeypatch)
    rng = np.random.default_rng(W)
    h = torch.from_numpy(rng.normal(size=(W, H)).astype(np.float32))
    g = graph.steepest(h, soil.d8)
    slot = graph.graph_to_slots(g, soil.d8)
    v0 = torch.from_numpy(rng.uniform(0.5, 2.0, (W, H)).astype(np.float32))
    d0 = torch.from_numpy(rng.uniform(0.8, 1.0, (W, H)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(W, H)).astype(np.float32))

    def grads(solve):
        v = v0.clone().requires_grad_(True)
        d = d0.clone().requires_grad_(True)
        out = solve(v, graph._edge_weights(g, d, soil.d8))
        assert out.requires_grad
        return out.detach(), torch.autograd.grad(out, (v, d), ct)

    got, (gv, gd) = grads(lambda v, w: gt.accumulate_tiled(
        slot, v, w, soil.d8, tile_solver="cuda"))
    dbl, (dv, dd) = grads(lambda v, w: graph._accumulate_doubling(g, v, w))
    plain, (pv, pd) = grads(lambda v, w: gt.accumulate_tiled(
        slot, v, w, soil.d8, tile_solver="plain"))
    assert torch.equal(got, plain)
    assert torch.equal(gv, dv) and torch.equal(gd, dd)
    np.testing.assert_allclose(gv.numpy(), pv.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gd.numpy(), pd.numpy(), rtol=1e-5,
                               atol=1e-5 * float(pd.abs().max()))


def test_scalar_decay_tensor_keeps_its_gradient():
    """`_edge_weights` with a 0-dim decay tensor: the weights carry the
    gradient back to it (D8, so the 1.414 exponent path is taken)."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(40, 30)).astype(np.float32))
    g = graph.steepest(h, soil.d8)
    d = torch.tensor(0.9, requires_grad=True)
    out = soil.accumulate_decay(g, 1.0, d, soil.d8, method="doubling")
    (gd,) = torch.autograd.grad(out.sum(), d)
    w = graph._edge_weights(g, 0.9, soil.d8)
    assert torch.equal(graph._edge_weights(g, d, soil.d8).detach(), w)
    assert float(gd) > 0.0
