"""Every CohortClosure variant of the port's plain cohort round against the
JAX package's, on the CPU: one round of each of the ten closures of
tests/test_grad_closures.py (the legacy split, offstep off and per
stream, uniform streams with xmom and perstream, face, sign, cluster and
speed node routing), the refusals the two packages share, and one small
erode step with the sign and the cluster rule. Eight rounds of each
closure are in tests/test_torch_closures_advance.py.

The JAX side runs eagerly (jax.disable_jit), as tests/test_grad_closures.py
runs it: a jit compile per variant would take minutes on the CPU, and the
values are what is compared. Inputs come from a numpy seed
(tests/test_torch_cuda.py `closure_state`). Tolerances are the JAX
package's kernel-vs-reference bars: one round rtol 2e-6 / atol 1e-5;
the erode step's solves, fed the same births, the multi-round bar rtol
2e-5 / atol 1e-5; the step's fields the coupled step's rtol 2e-5 with an
absolute floor of 1e-5 of each field's scale
(tests/test_torch_erosion.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.models.simulation import erode_step as jax_erode_step
from soillib_tpu.ops import cohort as jax_cohort
from soillib_tpu_torch.convert import state_from_numpy, state_to_numpy
from soillib_tpu_torch.models.simulation import erode_step
from soillib_tpu_torch.ops import cohort as port_cohort
from tests.test_torch_cohort import _problem
from tests.test_torch_cuda import CLOSURES, LLEN, closure_state
from tests.test_torch_erosion import _state_fields

torch.set_num_threads(1)

W, H = 32, 24


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def jax_closure(cl):
    """The JAX package's CohortClosure with the same fields."""
    return jax_cohort.CohortClosure(**dataclasses.asdict(cl))


# Albedo off where it is cheap: the one-node physics variants.
ONE_ROUND = ([(kind, True, name) for kind in ("fluvial", "debris")
              for name in CLOSURES]
             + [(kind, False, name) for kind in ("fluvial", "debris")
                for name in ("legacy", "offstep-off", "stream", "all-on")])


@pytest.mark.parametrize("kind,albedo,name", ONE_ROUND)
def test_cohort_round_variant_matches_jax(kind, albedo, name):
    cl = CLOSURES[name]
    st, aux = closure_state(kind, albedo, cl, W, H, seed=1)
    _, _, (jr, tr) = _problem(kind, albedo, W, H)
    C = port_cohort.n_deposits(st.shape[0], cl)
    G0 = np.zeros((C, W, H), np.float32)
    with jax.disable_jit():
        ja, jg = jax_cohort.cohort_round(
            jnp.asarray(st), jnp.asarray(G0), jnp.asarray(aux), jr, LLEN,
            jax_cohort.shift_push, jax_closure(cl))
    ta, tg = port_cohort.cohort_round(_t(st), _t(G0), _t(aux), tr, LLEN, cl)
    assert ta.shape == st.shape
    _close(ta, ja, 2e-6, 1e-5, "state")
    _close(tg, jg, 2e-6, 1e-5, "deposits")


@pytest.mark.parametrize("fields,message", [
    (dict(nodes=4, node_rule="sign", offsets=False, offstep=False),
     "offsets"),
    (dict(nodes=2, node_rule="sign"), "requires nodes=4"),
    (dict(nodes=2, node_rule="cluster"), "requires nodes=4"),
    (dict(nodes=4, node_rule="speed"), "requires nodes=2"),
])
def test_refusals_match_jax(fields, message):
    """The port refuses a closure with ValueError exactly where the JAX
    package does, in the round and in the birth masks."""
    cl = soil.CohortClosure(**fields)
    st, aux = closure_state("fluvial", True, soil.CohortClosure(), 8, 6)
    st = np.concatenate([st] * cl.nodes)
    _, _, (jr, tr) = _problem("fluvial", True, 8, 6)
    G0 = np.zeros((7, 8, 6), np.float32)
    with pytest.raises(ValueError, match=message), jax.disable_jit():
        jax_cohort.cohort_round(jnp.asarray(st), jnp.asarray(G0),
                                jnp.asarray(aux), jr, LLEN,
                                jax_cohort.shift_push, jax_closure(cl))
    with pytest.raises(ValueError, match=message):
        port_cohort.cohort_round(_t(st), _t(G0), _t(aux), tr, LLEN, cl)
    # Each of them is accepted with one node, where no rule is read.
    one = dataclasses.replace(cl, nodes=1)
    port_cohort.cohort_round(_t(st[:17]), _t(G0), _t(aux), tr, LLEN, one)


def _stack(x):
    """A solve's state or aux, handed over as one array or as channels, as
    one numpy array."""
    if isinstance(x, (tuple, list)):
        return np.stack([np.asarray(c) for c in x])
    return np.asarray(x)


@pytest.mark.parametrize("rule", ["sign", "cluster"])
def test_erode_step_node_rule_matches_jax(rule, monkeypatch):
    """One coupled step at 24 x 20 with CohortClosure(nodes=4, node_rule)
    at 4 rounds: the fluvial solve routes by the rule, the debris solve
    keeps the physics without the nodes (`_debris_closure`).

    Each package's cohort solves are recorded as the step runs them. The
    two packages' birth states agree to 2e-7 of their scale, and each
    solve, fed the other package's births, gives that package's deposits
    cell by cell at the multi-round bar (rtol 2e-5 / atol 1e-5). Under the
    sign rule the step's own fluvial deposits still miss that bar in a
    few cells: the quadrant shares divide face weights formed by
    cancellation (q_y = a - q_x), which amplifies the births' difference.
    So under the sign rule the fields the fluvial solve writes
    (discharge, mass, momentum) are held by their statistics (mean, std,
    max |.|) at the golden rtol 1e-3 (tests/test_golden.py); every other
    field, and every field under the cluster rule, cell by cell at the
    coupled step's bar."""
    fl = {k: v[..., :24, :20].copy() for k, v in _state_fields(5).items()}
    p = soil.ErosionParams()
    p.transportIterations = 4
    p.closure = soil.CohortClosure(nodes=4, node_rule=rule)
    jp = jsoil.ErosionParams()
    for name, value in p.freeze():
        setattr(jp, name, value)
    jp.closure = jax_closure(p.closure)
    scale = (0.1, 0.1, 4.0)
    solves = {"port": [], "jax": []}

    def spy(pkg, module):
        run = module.run_cohort

        def recorded(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
            G = run(st0, aux, rules, iters, Llen, closure, tol)
            solves[pkg].append((_stack(st0), _stack(aux), rules, iters,
                                Llen, closure, tol, np.asarray(G)))
            return G

        monkeypatch.setattr(module, "run_cohort", recorded)
        return run

    port_run = spy("port", port_cohort)
    jax_run = spy("jax", jax_cohort)
    out = state_to_numpy(erode_step(state_from_numpy(fl, "cpu"), scale, p))
    jstate = jsoil.ErosionState(**{k: jnp.asarray(v) for k, v in fl.items()})
    with jax.disable_jit():
        ref = jax_erode_step(jstate, scale, jp)
    assert [s[2].kind for s in solves["port"]] == ["fluvial", "debris"]
    assert len(solves["jax"]) == 2
    for mine, theirs in zip(solves["port"], solves["jax"]):
        st, aux, rules, iters, Llen, cl, tol, G = mine
        jst, jaux, jrules, _, _, jcl, _, jG = theirs
        kind = rules.kind
        assert st.shape == jst.shape
        _close(st, jst, 0.0, 2e-7 * float(np.abs(jst).max()),
               f"{kind} births")
        _close(aux, jaux, 0.0, 2e-7 * float(np.abs(jaux).max()),
               f"{kind} aux")
        got = port_run(_t(jst), _t(jaux), rules, iters, Llen, cl, tol)
        _close(got, jG, 2e-5, 1e-5, f"{kind} deposits on the JAX births")
        with jax.disable_jit():
            want = jax_run(jnp.asarray(st), jnp.asarray(aux), jrules, iters,
                           Llen, jcl, tol)
        _close(G, want, 2e-5, 1e-5, f"{kind} deposits on the port's births")
    for f in dataclasses.fields(ref):
        want = np.asarray(getattr(ref, f.name))
        got = out[f.name]
        if f.name == "albedo_debris":
            # A ratio of deposits, ill-conditioned where the debris mass is
            # ~1e-12 of nothing (tests/test_torch_erosion.py).
            got, want = got * out["debris"], want * np.asarray(ref.debris)
        if rule == "sign" and f.name in ("discharge", "mass", "momentum"):
            stats = [np.array([a.mean(), a.std(), np.abs(a).max()])
                     for a in (got, want)]
            _close(*stats, 1e-3, 0.0, f"{f.name} statistics")
            continue
        _close(got, want, 2e-5, 1e-5 * float(np.abs(want).max()), f.name)
