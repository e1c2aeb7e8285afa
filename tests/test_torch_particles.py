"""The port's Monte-Carlo particle estimators and gathers against the JAX
package's, on the CPU: the five gather cases of tests/test_sample.py,
`_solve_particles` (K = 1 and 2), `solve_uniform(method="particles")`,
`_fluvial_particles`, `_debris_particles`, both transports and one
coupled step with `transportMethod="particles"`, and `dem_process
--particles`.

The port draws its births from a torch.Generator, the JAX package from
threefry keys. Each comparison injects the JAX package's own uniforms into
the port (`transport._birth_uniforms` replaced), recomputed here as the
JAX functions draw them (`jax.random.split` of the key, `uniform` per
axis). Inputs come from a numpy seed, on a non-square grid so that W/H
swaps show.

Tolerances. A particle's deposit cell is floor(pos): a last-bit
difference in exp, sqrt or pow between XLA and torch can move one
particle to a neighbouring cell, and the rest of its trajectory differs.
So the short runs (at most 16 rounds: maxage 16, or a 6 x 10 grid for
`solve_uniform`, whose depth is W + H) compare per cell at rtol 2e-5 with
an absolute floor of 1e-6 of the field's largest magnitude, and the long
runs (64 rounds) compare each channel's total at rtol 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.models import erosion as jero
from soillib_tpu.models.simulation import erode_step as jax_erode_step
from soillib_tpu.ops import transport as jtr
from soillib_tpu_torch.convert import state_from_numpy, state_to_numpy
from soillib_tpu_torch.core.device import seeded_generator
from soillib_tpu_torch.models import erosion as pero
from soillib_tpu_torch.models.simulation import erode_step
from soillib_tpu_torch.ops import transport as ptr
from soillib_tpu_torch.testing import particle_state_fields

torch.set_num_threads(1)

W, H = 20, 24
SCALE = (0.1, 0.1, 4.0)
N_PARTICLES = 512
CELL_RTOL, CELL_ATOL = 2e-5, 1e-6   # per cell; atol times max |G|
TOTAL_RTOL = 1e-4                   # per-channel totals, long runs


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _per_cell(got, want, msg=""):
    """Per cell; inf and NaN (debris masses that overflowed) in the same
    cells, the absolute floor taken from the finite cells."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=msg)
    np.testing.assert_allclose(
        got, want, rtol=CELL_RTOL,
        atol=CELL_ATOL * float(np.abs(want[fin]).max(initial=0.0)),
        err_msg=msg)


def _totals(got, want, axes, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got.sum(axes), want.sum(axes),
                               rtol=TOTAL_RTOL, err_msg=msg)


def jax_uniforms(key, n):
    """The two birth draws of a JAX estimator called with `key`."""
    ka, kb = jax.random.split(key)
    return (np.asarray(jax.random.uniform(ka, (n,), jnp.float32)),
            np.asarray(jax.random.uniform(kb, (n,), jnp.float32)))


@pytest.fixture
def inject(monkeypatch):
    """inject(*keys_and_counts): the port's births take, call by call, the
    JAX package's draws for each (key, n) in turn."""
    def setup(*draws):
        queue = [jax_uniforms(k, n) for k, n in draws]

        def births(n, generator, device):
            ux, uy = queue.pop(0)
            assert len(ux) == n
            return _t(ux).to(device), _t(uy).to(device)

        monkeypatch.setattr(ptr, "_birth_uniforms", births)
        return queue
    return setup


# ---------------------------------------------------------------------------
# The gathers (tests/test_sample.py's five cases, and random positions)
# ---------------------------------------------------------------------------


def _field(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_bilinear_grad_value_matches_plain_gather():
    f = _field(0, 12, 9)
    pos = np.array([[3.25, 4.5], [0.0, 0.0], [10.99, 7.99], [11.0, 8.0]],
                   np.float32)
    v0 = ptr.bilinear_gather(_t(f), _t(pos))
    v1, _ = ptr.bilinear_gather_grad(_t(f), _t(pos))
    np.testing.assert_allclose(v0.numpy(), v1.numpy(), rtol=1e-6)
    want = jtr.bilinear_gather(jnp.asarray(f), jnp.asarray(pos))
    np.testing.assert_allclose(v0.numpy(), np.asarray(want), rtol=1e-6)


def test_bilinear_grad_matches_autodiff():
    """The analytic sample.hpp gradient == d(val)/d(pos) inside a cell,
    in the port (torch autograd) and in the JAX package (jacfwd)."""
    f = _field(1, 8, 8)
    p = np.array([3.3, 2.7], np.float32)
    _, g = ptr.bilinear_gather_grad(_t(f), _t(p)[None])
    ad = torch.autograd.functional.jacobian(
        lambda q: ptr.bilinear_gather(_t(f), q[None])[0], _t(p))
    np.testing.assert_allclose(g[0].numpy(), ad.numpy(), rtol=1e-5,
                               atol=1e-6)
    jad = jax.jacfwd(lambda q: jtr.bilinear_gather(jnp.asarray(f),
                                                   q[None])[0])(
        jnp.asarray(p))
    np.testing.assert_allclose(g[0].numpy(), np.asarray(jad), rtol=1e-5,
                               atol=1e-6)


def test_bilinear_grad_oob_nan_and_far_edge():
    f = _field(2, 6, 6)
    v, g = ptr.bilinear_gather_grad(_t(f), _t([[-0.5, 2.0], [2.0, 9.0]]))
    assert torch.isnan(v).all() and torch.isnan(g).all()
    # Far edge: pos.x in (W-2, W-1] drops the +1 sample (weight 0).
    v, g = ptr.bilinear_gather_grad(_t(f), _t([[5.0, 2.5]]))
    want = f[5, 2] + np.float32(0.5) * (f[5, 3] - f[5, 2])
    np.testing.assert_allclose(float(v[0]), float(want), rtol=1e-6)
    assert float(g[0, 0]) == 0.0


def test_linear_gather_val_grad():
    f = _t([1.0, 3.0, 2.0, 5.0])
    # Reference far-edge quirk: the whole last cell [N-2, N-1] drops the
    # +1 weight, so pos 2.25 freezes to f[2].
    v, g = ptr.linear_gather(f, _t([0.5, 2.25]))
    np.testing.assert_allclose(v.numpy(), [2.0, 2.0], rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), [2.0, 3.0], rtol=1e-6)
    v, g = ptr.linear_gather(f, _t([-0.1, 4.0]))
    assert torch.isnan(v).all()
    v, g = ptr.linear_gather(f, _t([3.0]))
    assert float(v[0]) == 5.0 and float(g[0]) == 0.0


def test_linear_gather_multichannel():
    f = _field(3, 7, 3)
    v, g = ptr.linear_gather(_t(f), _t([1.5]))
    np.testing.assert_allclose(v[0].numpy(), 0.5 * (f[1] + f[2]),
                               rtol=1e-6)
    np.testing.assert_allclose(g[0].numpy(), f[2] - f[1], rtol=1e-6)


@pytest.mark.parametrize("channels", [None, 3])
def test_gathers_match_jax_at_random_positions(channels):
    """Positions over and beyond the grid (NaN outside), on lattice lines
    and at the far edges, bitwise against the JAX package."""
    shape = (W, H) if channels is None else (W, H, channels)
    f = _field(4, *shape)
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1.5, [W + 0.5, H + 0.5], size=(400, 2))
    pos[:40] = np.floor(pos[:40])
    pos[40:50, 0], pos[50:60, 1] = W - 1.0, H - 1.0
    pos = pos.astype(np.float32)
    got = ptr.bilinear_gather(_t(f), _t(pos)).numpy()
    want = np.asarray(jtr.bilinear_gather(jnp.asarray(f), jnp.asarray(pos)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if channels is None:
        got = ptr.bilinear_gather_grad(_t(f), _t(pos))
        want = jtr.bilinear_gather_grad(jnp.asarray(f), jnp.asarray(pos))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    row = f.reshape(W * H, -1) if channels else f.reshape(-1)
    x = pos[:, 0] * H
    got = ptr.linear_gather(_t(row), _t(x))
    want = jtr.linear_gather(jnp.asarray(row), jnp.asarray(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# The DEM estimator: _solve_particles and solve_uniform(method="particles")
# ---------------------------------------------------------------------------


def _dem_problem(w, h, K, seed=6):
    rng = np.random.default_rng(seed)
    flow = rng.normal(size=(w, h, 2)).astype(np.float32)
    flow[1, 2] = 0.0  # a stagnant cell
    shape = (w, h) if K == 1 else (w, h, K)
    source = rng.random(shape).astype(np.float32)
    decay = (rng.random((w, h)) * 0.5).astype(np.float32)
    return flow, source, decay


@pytest.mark.parametrize("K,maxstep", [(1, 17), (2, 17), (1, 65), (2, 65)])
def test_solve_particles_matches_jax(inject, K, maxstep):
    flow, source, decay = _dem_problem(W, H, K)
    key = jax.random.PRNGKey(11 + K)
    want = jtr._solve_particles(jnp.asarray(flow), jnp.asarray(source),
                                jnp.asarray(decay), (2.0, 3.0), N_PARTICLES,
                                key, maxstep)
    inject((key, N_PARTICLES))
    got = ptr._solve_particles(_t(flow), _t(source), _t(decay), (2.0, 3.0),
                               N_PARTICLES, None, maxstep)
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    if maxstep <= 17:
        _per_cell(got.numpy(), want)
    else:
        _totals(got.numpy(), want, (0, 1))


@pytest.mark.parametrize("K,shape", [(1, (6, 10)), (2, (6, 10)),
                                     (2, (W, H))])
def test_solve_uniform_particles_matches_jax(inject, K, shape):
    """seed/offset select the stream as the JAX package's fold_in does;
    the default count is W*H. 6 x 10 runs W+H-1 = 15 rounds (per cell),
    20 x 24 runs 43 (totals)."""
    flow, source, decay = _dem_problem(*shape, K)
    want = jsoil.solve_uniform(flow, source, decay, (2.0, 3.0),
                               method="particles", seed=3, offset=5)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    inject((key, shape[0] * shape[1]))
    got = soil.solve_uniform(flow, source, decay, (2.0, 3.0),
                             method="particles", seed=3, offset=5,
                             device="cpu")
    assert got.shape == source.shape and got.device.type == "cpu"
    if shape == (6, 10):
        _per_cell(got.numpy(), want)
    else:
        _totals(got.numpy(), want, (0, 1))


def test_solve_uniform_particles_streams():
    """The port's own draws: deterministic in (seed, offset), another
    offset another estimate, a caller's generator advances."""
    flow, source, decay = _dem_problem(12, 8, 1)

    def run(**kw):
        return soil.solve_uniform(flow, source, decay, method="particles",
                                  device="cpu", **kw)

    a, b = run(seed=1, offset=2), run(seed=1, offset=2)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(seed=1, offset=3))
    g = seeded_generator("cpu", 1, 2)
    assert torch.equal(run(generator=g), a)
    assert not torch.equal(run(generator=g), a)  # it advanced
    assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# The erosion estimators, the transports and the coupled step
# ---------------------------------------------------------------------------


def _state_fields(seed):
    return particle_state_fields(W, H, seed)


def _params(maxage, **kw):
    """(port, JAX) particle parameters: N_PARTICLES particles, `maxage`."""
    p = soil.ErosionParams()
    p.transportMethod = "particles"
    p.nSamples = N_PARTICLES
    p.maxage = maxage
    for k, v in kw.items():
        setattr(p, k, v)
    jp = jsoil.ErosionParams()
    for name, value in p.freeze():
        setattr(jp, name, value)
    return p, jp


FLUVIAL_IN = ("layers", "rainfall", "discharge", "momentum",
              "albedo_surface")
DEBRIS_IN = ("layers", "debris", "debris_momentum", "albedo_surface")


@pytest.mark.parametrize("kind,maxage", [("fluvial", 16), ("debris", 16),
                                         ("fluvial", 65), ("debris", 65)])
def test_particle_estimator_matches_jax(inject, kind, maxage):
    """`_fluvial_particles` / `_debris_particles`: the flux, (W, H, C) in
    JAX, channel-first (C, W*H) in the port."""
    fl = _state_fields(7)
    p, jp = _params(maxage)
    key = jax.random.PRNGKey(21)
    names = FLUVIAL_IN if kind == "fluvial" else DEBRIS_IN
    if kind == "fluvial":
        want = jero._fluvial_particles(*(jnp.asarray(fl[k]) for k in names),
                                       SCALE, jp, key)
        fn = pero._fluvial_particles
    else:
        want = jero._debris_particles(*(jnp.asarray(fl[k]) for k in names),
                                      SCALE, jp, key)
        fn = pero._debris_particles
    inject((key, N_PARTICLES))
    got = fn(*(_t(fl[k]) for k in names), SCALE, p, None)
    C = 7 if kind == "fluvial" else 6
    assert got.shape == (C, W * H)
    got = got.T.reshape(W, H, C).numpy()
    want = np.asarray(want)
    assert float(np.abs(want[..., 0]).max()) > 0.0
    for c in range(C):
        if maxage <= 16:
            _per_cell(got[..., c], want[..., c], f"{kind} channel {c}")
        else:
            _totals(got[..., c], want[..., c], (0, 1), f"{kind} channel {c}")


def test_debris_mass_factor_grows_to_inf_where_jax_does(inject):
    """exp(+decay_d) is not clamped: with no yield stress and a fast
    suspension rate the carried mass grows along the trajectories and
    overflows to inf (and inf * 0 to NaN) in the same cells as in the JAX
    package; the finite cells agree per cell."""
    fl = _state_fields(8)
    p, jp = _params(16, yieldStress=0.0, suspensionRateDebris=5.0)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jero._debris_particles(
        *(jnp.asarray(fl[k]) for k in DEBRIS_IN), SCALE, jp, key))[..., 0]
    inject((key, N_PARTICLES))
    got = pero._debris_particles(*(_t(fl[k]) for k in DEBRIS_IN), SCALE, p,
                                 None)[0].reshape(W, H).numpy()
    assert np.isinf(want).any()
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _per_cell(got, want)


@pytest.mark.parametrize("kind", ["fluvial", "debris"])
def test_transport_particles_matches_jax(inject, kind):
    """transport_fluvial / transport_debris(method="particles") with the
    default key (the JAX package's PRNGKey(0)), maxage 16, per cell."""
    fl = _state_fields(9)
    p, jp = _params(16)
    key = jax.random.PRNGKey(0)
    if kind == "fluvial":
        args = ("layers", "rainfall", "discharge", "mass", "momentum",
                "albedo_surface")
        want = jsoil.transport_fluvial(*(jnp.asarray(fl[k]) for k in args),
                                       SCALE, jp)
        inject((key, N_PARTICLES))
        got = soil.transport_fluvial(*(_t(fl[k]) for k in args), SCALE, p)
    else:
        args = DEBRIS_IN
        want = jsoil.transport_debris(*(jnp.asarray(fl[k]) for k in args),
                                      SCALE, jp)
        inject((key, N_PARTICLES))
        got = soil.transport_debris(*(_t(fl[k]) for k in args), SCALE, p)
    for i, (a, b) in enumerate(zip(got, want)):
        _per_cell(a.numpy(), b, f"{kind} output {i}")


def test_erode_step_particles_matches_jax(inject):
    """One coupled step: the JAX step splits its key into the fluvial
    and the debris solve's; the port draws the two solves' births in
    program order (fluvial, then debris)."""
    fl = _state_fields(10)
    p, jp = _params(16)
    key = jax.random.PRNGKey(33)
    want = jax_erode_step(jsoil.ErosionState(
        **{k: jnp.asarray(v) for k, v in fl.items()}), SCALE, jp, key)
    kf, kd = jax.random.split(key)
    queue = inject((kf, N_PARTICLES), (kd, N_PARTICLES))
    got = erode_step(state_from_numpy(fl, "cpu"), SCALE, p,
                     seeded_generator("cpu"))
    assert queue == []
    got = state_to_numpy(got)
    for k, v in fl.items():
        w = np.asarray(getattr(want, k))
        _per_cell(got[k], w, k)


def test_erode_particles_generator_lives_on_the_state_device():
    """ErosionSim's generator is on its state's device and advances from
    step to step; erode(key=None) seeds one from 0 (PRNGKey(0))."""
    p, _ = _params(8)
    st = soil.ErosionState.zeros((12, 10), height=_state_fields(11)[
        "layers"][0][:12, :10], device="cpu")
    sim = soil.ErosionSim((12, 10), SCALE, p, state=st, seed=5,
                          device="cpu")
    assert sim.key.device == st.device
    a = sim.step()
    b = soil.ErosionSim((12, 10), SCALE, p, state=st, seed=5,
                        device="cpu").step()
    assert torch.equal(a.height, b.height)
    assert not torch.equal(sim.step().height, a.height)
    one = soil.erode(st, SCALE, p)
    again = soil.erode(st, SCALE, p,
                       key=seeded_generator("cpu", 0))
    assert torch.equal(one.discharge, again.discharge)
    assert bool(torch.isfinite(one.height).all())


def test_dem_process_particles_matches_jax(inject):
    """`dem_process --particles` on the CPU: the solve after the flow
    pipeline is solve_uniform(method="particles", seed=0) on the example's
    own velocity; fed the JAX package's draws it matches the JAX solve
    on the same inputs (16 x 16: 31 rounds, totals)."""
    from soillib_tpu_torch.examples import dem_process

    n = 16
    queue = inject((jax.random.fold_in(jax.random.PRNGKey(0), 0), n * n))
    run = dem_process.main(["--res", str(n), "--device", "cpu", "--out", "",
                            "--particles"])
    assert queue == []
    velocity = dem_process.velocity_of(run["gradient"])
    want = jsoil.solve_uniform(velocity.numpy(), np.ones((n, n), np.float32),
                               np.full((n, n), 0.001, np.float32),
                               (90.0, 90.0), method="particles", seed=0)
    got = run["discharge"].numpy()
    assert got.shape == (n, n) and np.isfinite(got).all()
    _totals(got, want, (0, 1))
    assert "solve_uniform" in run["ms"]


# ---------------------------------------------------------------------------
# The trajectory loop's dispatch and the kernel's constants
# (csrc/particle_rounds.cu runs on the card only; tests/test_torch_cuda.py
# holds it against the plain loop there)
# ---------------------------------------------------------------------------

ROUND_N, ROUND_P = 32, 256   # 32^2 grid, 256 particles, 16 rounds


def _round_inputs(kind, seed=3, **kw):
    from soillib_tpu_torch.testing import birth_draws, particle_round_inputs

    p, _ = _params(17, **kw)
    p.nSamples = ROUND_P
    return particle_round_inputs(
        kind, particle_state_fields(ROUND_N, ROUND_N, seed), SCALE, p, "cpu",
        birth_draws(ROUND_P, 1, seed + 1)[0])


def _kernel_sel(kind):
    """The deposit -> attenuation table compiled into
    csrc/particle_rounds.cu for `kind` (its `Kind<...>::sel`)."""
    import re
    from pathlib import Path

    import soillib_tpu_torch

    src = (Path(soillib_tpu_torch.__file__).parent / "csrc"
           / "particle_rounds.cu").read_text()
    body = re.search(r"struct Kind<%s> \{(.*?)\n\};" % kind.upper(), src,
                     re.S).group(1)
    table = re.search(r"int SEL\[C\] = \{([^}]*)\}", body).group(1)
    return tuple(int(v) for v in table.split(","))


@pytest.mark.parametrize("kind", ["fluvial", "debris"])
def test_advance_kernel_scalars_are_the_params(kind):
    """Each estimator's `advance` hands the kernel the ErosionParams
    constants its plain round uses, in csrc/particle_rounds.cu's order
    (`ParticleParams.r`), and its deposit -> attenuation map is the one
    compiled into the kernel. Every constant distinct, so a swap shows."""
    p, _ = _params(17, gravity=9.5, viscosityWater=2e-6, bedShearWater=11.0,
                   evapRate=6e-4, depositionRateFluvial=2e-5,
                   frictionFactor=0.07, force=(0.3, -0.2),
                   viscosityDebris=5e-3, bedShearDebris=0.03,
                   critSlopeBedrock=0.6, yieldStress=1.5e6,
                   depositionRateDebris=3e-4, suspensionRateDebris=4e-4)
    t = torch.zeros(4)
    if kind == "fluvial":
        adv = pero.FluvialAdvance(p, t, t, t, t, t)
        want = (9.5, 2e-6, 0.3, -0.2, 11.0 + 2e-6, 0.125 * (0.07 / 8.0),
                6e-4, 2e-5 * 1.33)
    else:
        adv = pero.DebrisAdvance(p, t, t, t, t)
        want = (9.5, 5e-3, 0.03, 0.6, 1.5e6, 3e-4, 4e-4, 0.0)
    assert adv.kind == kind
    assert adv.kernel_scalars() == want
    assert len(set(want)) == len(want)
    assert tuple(adv.sel) == _kernel_sel(kind)
    assert len(adv.lookups) == (5 if kind == "fluvial" else 4)
    # The start functions build the same object.
    args = _round_inputs(kind)
    assert type(args["advance"]) is type(adv)
    assert args["src"].shape[0] == len(adv.sel)
    assert args["att"].shape[0] == max(adv.sel) + 1


@pytest.mark.parametrize("kind", ["fluvial", "debris"])
def test_particle_rounds_on_cpu_is_the_plain_loop(kind):
    """CPU tensors run the plain loop: `_particle_rounds` gives its flux
    bit for bit, and the estimators' tensors are left as they were."""
    args = _round_inputs(kind)
    before = {k: v.clone() for k, v in args.items()
              if isinstance(v, torch.Tensor)}
    got = pero._particle_rounds(**args)
    want = pero._particle_rounds_plain(**args)
    assert got.shape == want.shape == (len(args["advance"].sel),
                                       ROUND_N * ROUND_N)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert float(torch.nan_to_num(want, posinf=0.0).abs().max()) > 0.0
    for k, v in before.items():
        assert torch.equal(args[k], v), k


def _kernel_emulation(W, H, rounds, px, py, ind, spx, spy, alive, src, att,
                      Llen, advance):
    """csrc/particle_rounds.cu's arithmetic in numpy float32 scalars, one
    particle at a time, its constants from `advance.kernel_scalars()` and
    its lookups from `advance.lookups`. Returns the flux (C, W*H)."""
    f = np.float32
    r = [f(v) for v in advance.kernel_scalars()]
    eps, sqrt2, tiny = f(1e-12), f(math.sqrt(2.0)), np.finfo(f).tiny
    bx, by, llen = f(W - 1e-3), f(H - 1e-3), f(Llen)
    sel, C = advance.sel, len(advance.sel)
    look = [t.numpy() for t in advance.lookups]
    src, att0 = src.numpy(), att.numpy()
    flux = np.zeros((W * H, C), f)

    def flush(v):
        return f(0.0) if abs(v) < tiny else v

    with np.errstate(all="ignore"):
        for i in range(px.shape[0]):
            x, y = f(px[i]), f(py[i])
            vx, vy = f(spx[i]), f(spy[i])
            cell, live = int(ind[i]), bool(alive[i])
            a, s = list(att0[:, i]), src[:, i]
            for _ in range(rounds):
                live = live and x >= 0 and y >= 0 and x < W and y < H
                if not live:
                    break
                nind = (int(min(max(x, f(0.0)), bx)) * H
                        + int(min(max(y, f(0.0)), by)))
                if nind != cell:
                    cell = nind
                    for c in range(C):
                        flux[cell, c] += s[c] * a[sel[c]]
                vn = np.sqrt(vx * vx + vy * vy)
                if not vn >= eps:
                    break
                ux, uy = vx / vn, vy / vn
                xn, yn = np.floor(x), np.floor(y)
                tx = np.fmin(np.fmax((xn - x) / ux, (xn + f(1.0) - x) / ux),
                             sqrt2)
                ty = np.fmin(np.fmax((yn - y) / uy, (yn + f(1.0) - y) / uy),
                             sqrt2)
                stp = f(0.5) * (tx + ty)
                dL = stp * llen
                ds = dL / vn
                g, nu = r[0], r[1]
                gx, gy, mx, my = (look[k][cell] for k in range(4))
                if advance.kind == "fluvial":
                    ax = -(g * gx) + nu * mx + r[2]
                    ay = -(g * gy) + nu * my + r[3]
                    w1 = f(1.0) / (f(1.0) + dL * r[4])
                    decay_v = r[5] / (eps + look[4][cell])
                    a = [a[0] * np.exp(-ds * r[6]), a[1] * np.exp(-ds * r[7]),
                         a[2] * np.exp(-dL * decay_v)]
                else:
                    dh = eps + a[0] * s[0]
                    ax = -(g * gx) + nu * mx
                    ay = -(g * gy) + nu * my
                    decay = nu + r[2] / dh
                    w1 = f(1.0) / (f(1.0) + dL * decay)
                    es = g * ((np.sqrt(gx * gx + gy * gy) - r[3])
                              - r[4] / dh)
                    rate = r[5] if es < 0 else r[6]
                    a = [flush(a[0] * flush(np.exp(ds * rate * es / vn))),
                         a[1] * np.exp(-dL * decay)]
                x, y = x + stp * ux, y + stp * uy
                vx, vy = w1 * vx + (dL * w1) * ax, w1 * vy + (dL * w1) * ay
    return torch.from_numpy(flux.T.copy())


@pytest.mark.parametrize("kind,kw", [
    ("fluvial", {}), ("debris", {}),
    ("debris", {"yieldStress": 0.0, "suspensionRateDebris": 5.0})])
def test_kernel_arithmetic_matches_the_plain_loop(kind, kw):
    """The kernel's per-particle arithmetic with the constants the
    wrapper hands it (`_kernel_emulation`, numpy float32) against the
    plain loop, per cell (the summation order differs: particle-major
    against round-major), non-finite cells (the debris mass factor grown
    to inf) in the same places."""
    args = _round_inputs(kind, **kw)
    got = _kernel_emulation(**args)
    want = pero._particle_rounds_plain(**args)
    for c in range(got.shape[0]):
        _per_cell(got[c].numpy(), want[c].numpy(), f"{kind} channel {c}")
    if kw:
        assert bool(torch.isinf(want[0]).any())


def test_particle_rounds_refuses_what_the_kernel_does_not_take():
    """Another device than the CPU and CUDA raises; the kernel's wrapper
    raises, without a launch, on CPU tensors and on an advance of another
    kind."""
    from soillib_tpu_torch.ops import particles

    launches = dict(particles.particle_launches)
    args = _round_inputs("fluvial")
    meta = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
            for k, v in args.items()}
    with pytest.raises(ValueError, match="device"):
        pero._particle_rounds(**meta)
    with pytest.raises(ValueError, match="CUDA"):
        particles.particle_rounds_cuda(**args)

    class Other(pero.FluvialAdvance):
        kind = "other"

    bad = Other.__new__(Other)
    bad.__dict__.update(args["advance"].__dict__)
    with pytest.raises(NotImplementedError):
        particles.particle_rounds_cuda(**{**args, "advance": bad})
    assert particles.particle_launches == launches
