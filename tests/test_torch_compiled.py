"""The compiled driver (`make_erode_fn`, `erode`, `ErosionSim`: the port's
counterpart of the JAX package's `_compiled_step`) on the CPU, where the
same `CapturedStep` runs its buffers, copies, donation and cache around an
eager step, at 32^2, 8 rounds, 3 steps.

- donate=True and donate=False are bitwise equal to each other and to the
  eager `erode_step` loop, and each is held against the JAX package's
  `make_erode_fn` with the same `donate` at tests/test_golden.py's
  trajectory bar (field statistics at rtol 1e-3; the one-step bar is
  tests/test_torch_erosion.py's, on the eager step);
- `ErosionSim(donate=True)` against the JAX package's, the same way;
- what donation and the cache promise;
- the cohort kernel path's device-side adaptive exit (`ops/cohort.py`
  `_advance`), scheduled with the plain rounds standing in for the
  kernel: it stops at the 16-round check where the host read stops, with
  the same deposits, bit for bit.

The card's side (capture, replay, the kernels, the counters) is in
tests/test_torch_cuda.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu_torch.convert import state_from_numpy, state_to_numpy
from soillib_tpu_torch.core.device import seeded_generator
from soillib_tpu_torch.models import simulation
from soillib_tpu_torch.models.erosion import make_fluvial_rules
from soillib_tpu_torch.ops import cohort
from soillib_tpu_torch.testing import cohort_arrays

torch.set_num_threads(1)

N = 32
SCALE = (0.1, 0.1, 4.0)
STEPS = 3


@pytest.fixture(autouse=True)
def fresh_cache():
    simulation._compiled.clear()
    yield
    simulation._compiled.clear()


def _fields(seed=0, n=N):
    """A seeded state: rough terrain, water, sediment, debris, momentum,
    albedos."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    u = lambda *s: rng.uniform(size=s).astype(np.float32)
    bed = 2.0 + 0.01 * np.cumsum(np.cumsum(f(n, n), axis=0), axis=1)
    return dict(
        layers=np.stack([bed, np.abs(f(n, n)) * 0.01]),
        rainfall=np.ones((n, n), np.float32),
        uplift=u(n, n),
        discharge=np.abs(f(n, n)),
        mass=np.abs(f(n, n)) * 1e-6,
        momentum=f(2, n, n) * 0.1,
        debris=np.abs(f(n, n)) * 1e-3,
        debris_momentum=f(2, n, n) * 0.1,
        albedo_bedrock=u(3, n, n),
        albedo_surface=u(3, n, n),
        albedo_fluvial=u(3, n, n),
        albedo_debris=u(3, n, n),
    )


def _params(iters=8):
    """(port, JAX) default parameters at `iters` transport rounds."""
    p = soil.ErosionParams()
    p.transportIterations = iters
    jp = jsoil.ErosionParams()
    for name, value in p.freeze():
        setattr(jp, name, value)
    return p, jp


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _assert_bitwise(a, b):
    for f in simulation.FIELDS:
        assert torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f))), f


def _eager(state, p, steps=STEPS, key=None):
    state = simulation._canonicalize(state, p)
    for _ in range(steps):
        state = simulation.erode_step(state, SCALE, p, key)
    return state


def test_make_erode_fn_donate_is_bitwise_the_eager_loop():
    fl = _fields(1)
    p, _ = _params()
    want = _eager(state_from_numpy(fl, "cpu"), p)
    kept = state_from_numpy(fl, "cpu")
    got = soil.make_erode_fn(p, SCALE, STEPS)(kept)
    _assert_bitwise(got, want)
    _assert_bitwise(kept, state_from_numpy(fl, "cpu"))  # only read
    donated = soil.make_erode_fn(p, SCALE, STEPS, donate=True)(
        state_from_numpy(fl, "cpu"))
    _assert_bitwise(donated, got)


def _jax_state(state):
    return jsoil.ErosionState(**{k: jnp.asarray(v)
                                 for k, v in state_to_numpy(state).items()})


def _stats_close_to_jax(out, ref):
    """tests/test_golden.py's trajectory bar: each field's mean, standard
    deviation and largest magnitude at rtol 1e-3; the debris albedo, a
    ratio of deposits, as the albedo mass it stands for."""
    got = state_to_numpy(out)
    for f in dataclasses.fields(ref):
        g, w = got[f.name], np.asarray(getattr(ref, f.name))
        if f.name == "albedo_debris":
            g, w = g * got["debris"], w * np.asarray(ref.debris)
        for stat in (np.mean, np.std, lambda a: np.abs(a).max()):
            np.testing.assert_allclose(stat(g), stat(w), rtol=1e-3,
                                       err_msg=f.name)


@pytest.mark.parametrize("donate", [False, True])
def test_make_erode_fn_matches_jax(donate):
    """The JAX package's make_erode_fn with the same `donate`, 3 steps, at
    the golden trajectory bar. Per cell the two packages' steps differ by
    more than the one-step bar in a few cells of these states, where f32
    roundoff crosses one of the model's switches (ROADMAP.md, queue C,
    "Known divergences"); the driver itself is held bitwise to the eager
    step above."""
    p, jp = _params()
    fl = _fields(2)
    out = soil.make_erode_fn(p, SCALE, STEPS, donate=donate)(
        state_from_numpy(fl, "cpu"))
    jstate = jsoil.ErosionState(**{k: jnp.asarray(v) for k, v in fl.items()})
    ref = jsoil.make_erode_fn(jp, SCALE, STEPS, donate=donate)(
        jstate, jax.random.PRNGKey(0))
    _stats_close_to_jax(out, ref)


def test_erosion_sim_donate_matches_jax():
    """ErosionSim(donate=True) against the JAX package's ErosionSim
    (donate=True) from the same state, 3 steps at the golden trajectory
    bar, and bitwise the eager loop's."""
    fl = _fields(3)
    p, jp = _params()
    sim = soil.ErosionSim((N, N), SCALE, p, state=state_from_numpy(fl, "cpu"),
                          donate=True, device="cpu")
    jsim = jsoil.ErosionSim((N, N), SCALE, jp, state=jsoil.ErosionState(
        **{k: jnp.asarray(v) for k, v in fl.items()}), donate=True)
    for _ in range(STEPS):
        sim.step()
        jsim.step()
    _stats_close_to_jax(sim.state, jsim.state)
    _assert_bitwise(sim.state, _eager(state_from_numpy(fl, "cpu"), p))


def test_undonated_result_is_unchanged_by_a_later_call():
    p, _ = _params()
    fn = soil.make_erode_fn(p, SCALE, 1)
    first = fn(state_from_numpy(_fields(4), "cpu"))
    kept = {f: getattr(first, f).clone() for f in simulation.FIELDS}
    second = fn(first)
    fn(state_from_numpy(_fields(5), "cpu"))
    for f in simulation.FIELDS:
        assert torch.equal(getattr(first, f), kept[f]), f
    assert not torch.equal(second.layers, first.layers)
    # The copy just returned goes back in without a copy; once changed in
    # place, it is copied.
    (step,) = simulation._compiled.values()
    third = fn(second)
    versions = {f: step.static[f]._version for f in simulation.FIELDS}
    step._copy_in({f: getattr(third, f) for f in simulation.FIELDS})
    assert {f: step.static[f]._version for f in simulation.FIELDS} == versions
    third.layers.mul_(1.0)
    step._copy_in({f: getattr(third, f) for f in simulation.FIELDS})
    assert step.static["layers"]._version == versions["layers"] + 1
    assert step.static["mass"]._version == versions["mass"]
    _assert_bitwise(fn(third), _eager(third, p, 1))


def test_donated_state_is_the_buffers_and_goes_back_uncopied():
    p, _ = _params()
    fn = soil.make_erode_fn(p, SCALE, 1, donate=True)
    a = fn(state_from_numpy(_fields(6), "cpu"))
    (step,) = simulation._compiled.values()
    for f in simulation.FIELDS:
        assert getattr(a, f) is step.static[f], f
    before = {f: getattr(a, f).clone() for f in simulation.FIELDS}
    b = fn(a)
    assert b.layers is a.layers  # the same buffers, stepped in place
    ref = _eager(state_from_numpy(before, "cpu"), p, 1)
    _assert_bitwise(b, ref)


def test_cache_keys_and_bound():
    p, _ = _params()
    fn = soil.make_erode_fn(p, SCALE, 1)
    st = state_from_numpy(_fields(7), "cpu")
    want = fn(st)
    p.transportIterations = 2  # a later edit of param does not reach fn
    _assert_bitwise(fn(st), want)
    assert len(simulation._compiled) == 1
    fn(state_from_numpy(_fields(7, n=16), "cpu"))  # another shape
    assert len(simulation._compiled) == 2
    soil.make_erode_fn(p, SCALE, 1)(st)  # other parameters
    soil.make_erode_fn(p, SCALE, 1, donate=True)(st)  # donate is in the key
    assert len(simulation._compiled) == 4
    first = next(iter(simulation._compiled))
    soil.make_erode_fn(p, (0.2, 0.2, 4.0), 1)(st)
    assert len(simulation._compiled) == simulation.COMPILED_STEPS
    assert first not in simulation._compiled  # the oldest went


def test_compact_albedo_shares_the_full_size_step():
    """With albedo tracked, a state of (3, 1, 1) albedos and the full-size
    states after it run one compiled step, the eager loop's bits."""
    p, _ = _params()
    p.trackAlbedo = True
    st = soil.ErosionState.zeros((N, N), height=_fields(8)["layers"][0],
                                 albedo_surface=(0.2, 0.5, 0.9),
                                 device="cpu")
    fn = soil.make_erode_fn(p, SCALE, 1)
    out = fn(fn(st))
    assert len(simulation._compiled) == 1
    assert tuple(out.albedo_surface.shape) == (3, N, N)
    _assert_bitwise(out, _eager(st, p, 2))


def test_particle_step_draws_as_the_eager_step():
    """The particle transports' births come from the caller's generator,
    which advances as the eager steps advance it (bit patterns: the
    debris estimator's overflow leaves NaNs, in the same cells)."""
    p, _ = _params()
    p.transportMethod = "particles"
    p.nSamples = 256
    p.maxage = 12
    st = state_from_numpy(_fields(9), "cpu")
    sim = soil.ErosionSim((N, N), SCALE, p, state=st, seed=4, device="cpu")
    sim.step(2)
    sim.step()
    g = seeded_generator("cpu", 4)
    _assert_bitwise(sim.state, _eager(st, p, 3, g))
    assert torch.equal(sim.key.get_state(), g.get_state())
    # key=None draws from a generator seeded from 0, as erode_step does.
    _assert_bitwise(soil.erode(st, SCALE, p, 1),
                    _eager(st, p, 1, seeded_generator("cpu", 0)))


def test_state_that_requires_grad_runs_the_eager_step():
    """Reverse mode goes through the eager step: gradients through
    make_erode_fn are erode_step's."""
    fl = _fields(10, n=16)
    p, _ = _params(4)

    def grad(run):
        st = state_from_numpy(fl, "cpu")
        h = st.layers.clone().requires_grad_(True)
        out = run(st.replace(layers=h))
        out.discharge.sum().backward()
        return h.grad

    g = grad(lambda s: soil.make_erode_fn(p, SCALE, 2)(s))
    assert len(simulation._compiled) == 0
    want = grad(lambda s: _eager(s, p, 2))
    assert torch.equal(g, want)
    assert float(g.abs().sum()) > 0.0


def _boundary_ratios(st, aux, rules, iters, every):
    """max over channels of live x remaining / gauge at each exit check of
    the plain rounds (the contractive criterion's ratio)."""
    G = torch.zeros((st.shape[0] - cohort.NSTATE,) + tuple(st.shape[1:]))
    out = {}
    for i in range(iters):
        if i % every == 0:
            live = cohort.carried_live(st).double()
            gauge = cohort.deposit_gauge(G).double()
            out[i] = float((live * (iters - i) / gauge).max())
        st, G = cohort.cohort_round(st, G, aux, rules, math.sqrt(0.02))
    return out


@pytest.mark.parametrize("exit_at", [16, 32, 48])
def test_device_exit_stops_where_the_host_read_stops(exit_at):
    """`_advance` with the plain rounds standing in for the kernel (a
    launch that does nothing while `done` is set): the device flag and the
    host read stop at the same TOL_CHECK_ROUNDS check, with the same
    deposits, bit for bit."""
    iters, every = 64, cohort.TOL_CHECK_ROUNDS
    st, aux = (torch.from_numpy(a) for a in cohort_arrays(
        "fluvial", True, 24, 20, seed=11))
    Llen = math.sqrt(0.02)
    rules = make_fluvial_rules(soil.ErosionParams(), Llen, True)
    assert rules.contractive
    q = _boundary_ratios(st, aux, rules, iters, every)
    assert q[16] > q[32] > q[48] > 0.0
    # A tol between this check's ratio and the previous one's.
    tol = (2.0 * q[exit_at] if exit_at == every
           else math.sqrt(q[exit_at] * q[exit_at - every]))

    def run(device_exit):
        ran = []

        def launch(s, a, G, rules, Llen, rounds, out, nodes, closure,
                   done=None):
            if done is not None and bool(done):
                return out
            s2, G2 = cohort._plain_rounds(s, G, a, rules, Llen, closure,
                                          rounds)
            G.copy_(G2)
            out.copy_(s2)
            ran.append(rounds)
            return out

        _, G, _ = cohort._advance(st, aux, rules, iters, Llen, tol, None,
                                  None, launch, device_exit)
        return G, sum(ran)

    g_host, n_host = run(False)
    g_dev, n_dev = run(True)
    assert n_host == n_dev == exit_at
    assert torch.equal(_bits(g_host), _bits(g_dev))
