"""The port's quality closures (CohortClosure nodes and colors) against the
JAX package on the CPU: the birth-partition masks, the N-node face-routed
round, colored solves and a quality erode step. The fluvial transport
with `CohortClosure(nodes=4, colors=8)` is held against JAX in
tests/test_torch_quality_transport.py.

Inputs are made from a numpy seed (tests/test_torch_cuda.py
`cohort_arrays`, one seed per node). Tolerances: the masks are integer
decisions and compare bitwise; one round rtol 2e-6 / atol 1e-5 and
several rounds rtol 2e-5 / atol 1e-5 (the JAX kernel-vs-reference bars).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu_torch as soil
from soillib_tpu.models import erosion as jax_erosion
from soillib_tpu.ops import cohort as jax_cohort
from soillib_tpu_torch.models import erosion as port_erosion
from soillib_tpu_torch.ops import cohort as port_cohort
from tests.test_torch_cohort import _problem
from tests.test_torch_cuda import LLEN, cohort_arrays

torch.set_num_threads(1)

QUALITY = dict(nodes=4, colors=8)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _speed(W=64, H=48, seed=0):
    """A speed field with every sign pattern, exact ties and still
    cells."""
    rng = np.random.default_rng(seed)
    sp = rng.normal(size=(2, W, H)).astype(np.float32)
    sp[:, :4, :4] = 0.0                      # still cells
    sp[1, 4:8, :8] = sp[0, 4:8, :8]          # |vx| == |vy| ties
    sp[0, 8:10] = 0.0                        # on the axes
    return sp


@pytest.mark.parametrize("rule", ["dir", "hash", "peak"])
def test_color_masks_match_jax(rule):
    sp = _speed()
    for M in (2, 8):
        got = port_erosion._color_masks(M, rule, _t(sp), sp.shape[1:])
        want = jax_erosion._color_masks(M, rule, jnp.asarray(sp),
                                        sp.shape[1:])
        assert len(got) == M
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert bool((sum(got) == 1.0).all())


@pytest.mark.parametrize("rule,nodes", [("face", 2), ("face", 4),
                                        ("sign", 4), ("cluster", 4),
                                        ("speed", 2)])
def test_node_masks_match_jax(rule, nodes):
    sp = _speed(seed=1)
    got = port_erosion._node_masks(nodes, _t(sp), rule)
    want = jax_erosion._node_masks(nodes, jnp.asarray(sp), rule)
    assert len(got) == nodes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_debris_closure_strips_quality_knobs():
    """As tests/test_cohort_colors.py: the debris transport strips nodes
    and colors from the quality closure unless closureDebris says
    otherwise, so a quality run's debris transport equals the default
    one."""
    p = soil.ErosionParams()
    p.closure = soil.CohortClosure(nodes=4, colors=2)
    cd = port_erosion._debris_closure(p)
    assert cd.nodes == 1 and cd.colors == 1
    assert cd.offsets == p.closure.offsets
    p.closureDebris = "same"
    assert port_erosion._debris_closure(p) is p.closure
    explicit = soil.CohortClosure(nodes=2)
    p.closureDebris = explicit
    assert port_erosion._debris_closure(p) is explicit
    assert port_erosion._debris_closure(soil.ErosionParams()) is None

    h = soil.noise((32, 32), soil.noise_t(seed=4.0, ext=(32, 32)),
                   device="cpu")
    st = soil.ErosionState.zeros((32, 32), height=1.0 + 0.3 * h,
                                 device="cpu")
    pq = soil.ErosionParams()
    pq.transportIterations = 8
    pq.closure = soil.CohortClosure(nodes=4, colors=2)
    pd = soil.ErosionParams()
    pd.transportIterations = 8
    args = (st.layers, st.mass, st.momentum, st.albedo_surface,
            (0.1, 0.1, 1.0))
    for a, b in zip(soil.transport_debris(*args, pq),
                    soil.transport_debris(*args, pd)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _node_state(kind, albedo, nodes, W, H, seed=0):
    """A node-stacked state: one seeded ensemble per node."""
    sts = [cohort_arrays(kind, albedo, W, H, seed + 10 * j)
           for j in range(nodes)]
    return np.concatenate([s for s, _ in sts]), sts[0][1]


@pytest.mark.parametrize("kind", ["fluvial", "debris"])
@pytest.mark.parametrize("nodes", [2, 4])
def test_cohort_round_nodes_matches_jax(kind, nodes):
    st, aux = _node_state(kind, True, nodes, 40, 36, seed=3)
    _, _, (jr, tr) = _problem(kind, True, 40, 36)
    C = st.shape[0] // nodes - port_cohort.NSTATE
    G0 = np.zeros((C,) + st.shape[1:], np.float32)
    ja, jg = jax_cohort.cohort_round(
        jnp.asarray(st), jnp.asarray(G0), jnp.asarray(aux), jr, LLEN,
        jax_cohort.shift_push, jax_cohort.CohortClosure(nodes=nodes))
    ta, tg = port_cohort.cohort_round(_t(st), _t(G0), _t(aux), tr, LLEN,
                                      soil.CohortClosure(nodes=nodes))
    assert ta.shape == st.shape
    _close(ta, ja, 2e-6, 1e-5, "state")
    _close(tg, jg, 2e-6, 1e-5, "deposits")


def test_cohort_advance_colors_nodes_matches_jax():
    """colors=2 x nodes=4 (8 ensembles), 12 rounds."""
    st, aux = _node_state("fluvial", True, 8, 24, 20, seed=5)
    _, _, (jr, tr) = _problem("fluvial", True, 24, 20)
    jcl = jax_cohort.CohortClosure(nodes=4, colors=2)
    pcl = soil.CohortClosure(nodes=4, colors=2)
    _, jg = jax_cohort.cohort_advance_reference(
        jnp.asarray(st), jnp.asarray(aux), jr, 12, LLEN, closure=jcl)
    _, tg = port_cohort.cohort_advance_reference(_t(st), _t(aux), tr, 12,
                                                 LLEN, closure=pcl)
    _close(tg, jg, 2e-5, 1e-5, "deposits after 12 rounds")
    live = port_cohort.carried_live(_t(st), pcl)
    _close(live, jax_cohort.carried_live(jnp.asarray(st), jcl), 1e-6, 0.0,
           "carried_live")
    assert port_cohort.n_deposits(st.shape[0], pcl) == 7


@pytest.mark.parametrize("M", [2, 4])
def test_batched_colors_match_looped(M):
    """M color groups through one solve == M single-color solves summed
    (tests/test_cohort_colors.py's bar, rtol 2e-6 / atol 1e-6)."""
    st0, aux = cohort_arrays("debris", True, 48, 40, seed=7)
    _, _, (_, tr) = _problem("debris", True, 48, 40)
    W, H = st0.shape[1:]
    cell = (np.arange(W)[:, None] * 7 + np.arange(H)[None, :] * 13) % M
    masks = [(cell == j).astype(np.float32) for j in range(M)]
    stc = np.concatenate([st0 * m[None] for m in masks])
    _, g_b = port_cohort.cohort_advance_reference(
        _t(stc), _t(aux), tr, 12, LLEN, closure=soil.CohortClosure(colors=M))
    g_l = None
    for m in masks:
        _, g = port_cohort.cohort_advance_reference(_t(st0 * m[None]),
                                                    _t(aux), tr, 12, LLEN)
        g_l = g if g_l is None else g_l + g
    _close(g_b, g_l, 2e-6, 1e-6)


def test_quality_erode_step():
    """One quality-closure erode step at 32^2 on the plain path: finite,
    every color solve went through one batched solve, and the fluvial
    deposits differ from the default closure's (nodes and colors change
    the mixture) while the debris fields do not."""
    h = soil.noise((32, 32), soil.noise_t(seed=3.0, ext=(32, 32)),
                   device="cpu")
    st = soil.ErosionState.zeros((32, 32), height=1.0 + 0.3 * h,
                                 device="cpu")
    p = soil.ErosionParams()
    p.transportIterations = 8
    q = soil.ErosionParams.from_frozen(p.freeze())
    q.closure = soil.CohortClosure(**QUALITY)
    calls = []
    run = port_cohort.run_cohort

    def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        calls.append((rules.kind, tuple(port_cohort.as_stack(st0).shape),
                      closure))
        return run(st0, aux, rules, iters, Llen, closure, tol)

    port_cohort.run_cohort = spy
    try:
        out_q = soil.erode(st, (0.1, 0.1, 4.0), q)
    finally:
        port_cohort.run_cohort = run
    out_d = soil.erode(st, (0.1, 0.1, 4.0), p)
    assert calls[0][0] == "fluvial" and calls[0][1] == (8 * 4 * 17, 32, 32)
    assert calls[0][2].colors == 8 and calls[0][2].nodes == 4
    assert calls[1][0] == "debris" and calls[1][1] == (16, 32, 32)
    for f in ("height", "discharge", "sediment", "debris"):
        assert bool(torch.isfinite(getattr(out_q, f)).all()), f
    assert not torch.equal(out_q.discharge, out_d.discharge)
    torch.testing.assert_close(out_q.debris, out_d.debris, rtol=0, atol=0)
