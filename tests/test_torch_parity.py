"""The port's study harnesses (`soillib_tpu_torch.benchmarks.parity` and
its probes) against the JAX harness `benchmarks/parity.py`, imported by
path (its `main` not run but in the key test), on the CPU at 16^2 with
maxage 16 and 4 seeds.

Inputs are shared, never re-derived: the terrains are compared bitwise
(the JAX harness's numpy calls and the noise, `tests/test_torch_noise.py`'s
bar); the warm state is made once by the JAX harness and carried to the
port (`convert.state_from_numpy`), because one step from a mid-run state
can differ from JAX's beyond the one-step bar (ROADMAP queue C.3); the
particle estimators take the JAX package's own birth uniforms for the
keys the JAX harness draws with (`transport._birth_uniforms` replaced).

Tolerances. `metrics` and `_phase_report` on the same numpy inputs agree
to float64 roundoff (rtol 1e-12). A field-vs-MC metric is a smooth
function of the two fields over the interior, and each field agrees with
JAX's per cell within the one-solve bar (rtol 2e-5; the particle
estimators at maxage 16 at rtol 2e-5 / atol 1e-6 of the field's scale,
tests/test_torch_particles.py), so each metric is held within 2e-5 of
max(1, |metric|). The age probe's per-round water totals are held at
rtol 2e-5 with an absolute floor of 1e-6 of the largest round's total.
About 50 s in one process, most of it the JAX side compiling.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
from soillib_tpu.models import erosion as jero
from soillib_tpu.ops import cohort as jco
from soillib_tpu_torch.benchmarks import age_deficit_probe, residual_probe
from soillib_tpu_torch.benchmarks import parity as pp
from soillib_tpu_torch.convert import params_from_frozen, state_from_numpy
from soillib_tpu_torch.core.device import seeded_generator
from soillib_tpu_torch.ops import transport as ptr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, MAXAGE, SEEDS = 16, 16, 4
SCALE = (0.078, 0.078, 4.0)
METRIC_RTOL = 2e-5
STATE_FIELDS = ("layers", "rainfall", "uplift", "discharge", "mass",
                "momentum", "debris", "debris_momentum", "albedo_bedrock",
                "albedo_surface", "albedo_fluvial", "albedo_debris")


def _load_jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_harness", os.path.join(REPO, "benchmarks", "parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jp = _load_jax_harness()


def _jax_param(nsamples=N * N * 16):
    """The JAX harness's `main` parameters at MAXAGE."""
    p = jsoil.ErosionParams()
    p.maxage = MAXAGE
    p.transportIterations = MAXAGE - 2
    p.nSamples = nsamples
    p.timeStep = 500.0
    return p


def _port(p):
    return params_from_frozen(p.freeze())


def _uniforms(key, n):
    """The two birth draws of a JAX estimator called with `key`."""
    ka, kb = jax.random.split(key)
    return (np.array(jax.random.uniform(ka, (n,), jnp.float32)),
            np.array(jax.random.uniform(kb, (n,), jnp.float32)))


@pytest.fixture
def inject(monkeypatch):
    """inject(pairs): the port's births take these (ux, uy) pairs in
    turn; returns the list of pairs not taken yet."""
    def setup(pairs):
        queue = list(pairs)

        def births(n, generator, device):
            ux, uy = queue.pop(0)
            assert len(ux) == n
            return torch.from_numpy(ux).to(device), torch.from_numpy(uy).to(
                device)

        monkeypatch.setattr(ptr, "_birth_uniforms", births)
        return queue
    return setup


def _mc_draws(n_seeds, n, base_seed=0):
    """JAX's births for the keys of the JAX harness's `mc_average`."""
    return [_uniforms(jax.random.PRNGKey(base_seed + 1000 + s), n)
            for s in range(n_seeds)]


def _coupled_draws(steps, n_rep, n):
    """JAX's births of `compare_coupled`'s particle runs: `erode` splits
    each rep's key once a step, `erode_step` that key into the fluvial
    and the debris solve's."""
    out = []
    for r in range(n_rep):
        k = jax.random.PRNGKey(100 + r)
        for _ in range(steps):
            k, sub = jax.random.split(k)
            kf, kd = jax.random.split(sub)
            out += [_uniforms(kf, n), _uniforms(kd, n)]
    return out


def _assert_metrics(got, want, msg=""):
    """Two reports of equal keys, each number within METRIC_RTOL of
    max(1, |want|)."""
    assert pp.key_paths(got) == pp.key_paths(want), msg
    for path in pp.key_paths(want):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert abs(g - w) <= METRIC_RTOL * max(1.0, abs(w)), (msg, path, g, w)


@pytest.fixture(scope="module")
def warm():
    """The steep terrain warmed 8 field steps by the JAX harness, as numpy
    fields (steep: the debris phase carries signal at 16^2)."""
    terr = jp.make_terrains(N, ("steep",))["steep"]
    st = jp.make_state(terr, 8, SCALE, _jax_param())
    return terr, {k: np.array(getattr(st, k)) for k in STATE_FIELDS}


@pytest.fixture(scope="module")
def jax_reports(warm):
    """The JAX harness's comparisons: both phases on the warm state
    (SEEDS seeds), the coupled runs from the terrain (2 steps, n_rep 2)."""
    terr, fields = warm
    p = _jax_param()
    st = jsoil.ErosionState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return {"fluvial": jp.compare_fluvial(st, SCALE, p, SEEDS),
            "debris": jp.compare_debris(st, SCALE, p, SEEDS),
            "coupled": jp.compare_coupled(terr, SCALE,
                                          _jax_param(N * N * 64), 2,
                                          n_rep=2)}


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", pp.TERRAINS)
def test_terrains_match_the_jax_harness_bitwise(name):
    want = jp.make_terrains(24, (name,))
    got = pp.make_terrains(24, (name,), "cpu")
    assert list(got) == [name]
    g = got[name].numpy()
    assert g.dtype == np.float32 and g.shape == (24, 24)
    np.testing.assert_array_equal(g.view(np.int32),
                                  want[name].view(np.int32))


def test_terrains_come_in_the_jax_order():
    assert list(pp.make_terrains(8, ("steep", "ramp", "noise"), "cpu")) == [
        "ramp", "noise", "steep"]


def _fields(seed, C=None, n=12):
    rng = np.random.default_rng(seed)
    shape = (n, n) if C is None else (C, n, n)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "channels", "constant",
                                  "zero-mean"])
def test_metrics_match_the_jax_harness(case):
    a, b = _fields(1), _fields(2)
    if case == "channels":
        a, b = _fields(3, 2), _fields(4, 2)
    elif case == "constant":  # the std == 0 branch, equal and not
        a = np.full((12, 12), 0.5, np.float32)
        b = a.copy()
    elif case == "zero-mean":
        b = np.zeros((12, 12), np.float32)
    want = jp.metrics(a, b)
    got = pp.metrics(torch.from_numpy(a), torch.from_numpy(b))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0.0)
    if case == "constant":
        assert jp.metrics(a, b + 1.0)["corr"] == pp.metrics(
            a, b + 1.0)["corr"] == 0.0


@pytest.mark.parametrize("phase", ["fluvial", "debris"])
def test_phase_report_matches_the_jax_harness(phase):
    """Same numpy outputs: the mass-weighted albedo (cells below 1% of the
    mean of the lesser mass weighted out) and the split-half noise."""
    names = pp.FLUVIAL_FIELDS if phase == "fluvial" else pp.DEBRIS_FIELDS
    mass_idx = 1 if phase == "fluvial" else 0

    def outputs(seed):
        out = []
        for i, name in enumerate(names):
            C = 2 if name == "momentum" else 3 if name == "albedo" else None
            f = _fields(seed * 10 + i, C)
            out.append(np.abs(f) * (i == mass_idx) + f * (i != mass_idx))
        return out

    f, mc, ha, hb = (outputs(s) for s in (1, 2, 3, 4))
    f[mass_idx][:4] = 0.0  # a low-mass band, weighted out
    want = jp._phase_report(names, f, mc, ha, hb, mass_idx)
    got = pp._phase_report(names, *([torch.from_numpy(x) for x in t]
                                    for t in (f, mc, ha, hb)), mass_idx)
    assert pp.key_paths(got) == pp.key_paths(want)
    for name in names:
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k],
                                       rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("phase", ["fluvial", "debris"])
def test_single_phase_comparison_matches_the_jax_harness(warm, jax_reports,
                                                         inject, phase):
    """compare_fluvial / compare_debris on one JAX-made warm state, the
    MC half with JAX's births for the harness's seeds."""
    _, fields = warm
    p = _port(_jax_param())
    fn = pp.compare_fluvial if phase == "fluvial" else pp.compare_debris
    left = inject(_mc_draws(SEEDS, p.nSamples))
    got = fn(state_from_numpy(fields, "cpu"), SCALE, p, SEEDS)
    assert left == []
    want = jax_reports[phase]
    _assert_metrics(got, want, phase)
    # The oracle carries signal here: not a comparison of zeros.
    mass = "mass" if phase == "debris" else "discharge"
    assert 0.0 < want[mass]["nrmse"]


def test_coupled_comparison_matches_the_jax_harness(warm, jax_reports,
                                                    inject):
    """compare_coupled at 2 steps, n_rep = 2: the field trajectory and
    both particle trajectories (JAX's births injected, step by step)."""
    terr, _ = warm
    p = _port(_jax_param(N * N * 64))
    left = inject(_coupled_draws(2, 2, p.nSamples))
    got = pp.compare_coupled(torch.from_numpy(terr), SCALE, p, 2, n_rep=2)
    assert left == []
    want = jax_reports["coupled"]
    _assert_metrics(got, want, "coupled")
    assert want["discharge"]["mc_vs_mc_corr"] < 1.0  # the reps differ


def test_mc_average_halves(inject):
    """The halves are the even and the odd seeds' means, the mean their
    weighted mean; an odd count gives half a one more seed."""
    seen = []

    def fn(g):
        seen.append(g.initial_seed())
        v = float(len(seen))
        return (torch.full((2, 2), v), torch.full((3,), -v))

    mean, ha, hb = pp.mc_average(fn, 3, base_seed=5, device="cpu")
    assert len(set(seen)) == 3
    np.testing.assert_allclose(ha[0].numpy(), 2.0)   # seeds 1 and 3
    np.testing.assert_allclose(hb[0].numpy(), 2.0)   # seed 2
    np.testing.assert_allclose(mean[1].numpy(), -2.0)
    torch.testing.assert_close(
        pp.mc_average(fn, 2, base_seed=5, device="cpu")[1][0],
        torch.full((2, 2), 4.0))


def test_seeded_generators_draw_per_seed_on_the_cpu():
    """Another seed or offset, other numbers; the same pair, the same
    numbers. (The CPU's mt19937 keeps only the low 32 bits of a seed: the
    key is mixed before seeding, or every seed of one offset drew the
    same stream and the MC halves above were equal.)"""
    def draw(seed, offset=0):
        return torch.rand(64, generator=seeded_generator("cpu", seed, offset))

    seeds = [draw(s) for s in (0, 1, 2, 1000, 1001)]
    for i in range(len(seeds)):
        for j in range(i + 1, len(seeds)):
            assert not torch.equal(seeds[i], seeds[j]), (i, j)
    assert not torch.equal(draw(1, 0), draw(1, 1))
    assert not torch.equal(draw(0, 1), draw(1, 0))
    assert torch.equal(draw(7, 3), draw(7, 3))


def test_main_writes_the_jax_harness_keys(tmp_path, monkeypatch,
                                         jax_reports):
    """The port's `main(["--quick", "--cpu", ...])` writes the JAX
    harness's keys, and where it ran, its seconds and its peak memory.
    The JAX harness's `main` assembles its report from its compare
    functions, stood in here by their real outputs on the 16^2 warm
    state, so its keys are its own."""
    for name in ("fluvial", "debris", "coupled"):
        monkeypatch.setattr(jp, f"compare_{name}",
                            lambda *a, _r=jax_reports[name], **k: _r)
    monkeypatch.setattr(jp, "make_state", lambda *a, **k: None)
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    flags = ["--quick", "--cpu", "--size", str(N), "--maxage", "8"]
    monkeypatch.setattr(sys, "argv", ["parity.py", *flags, "--out",
                                      str(jax_out)])
    jp.main()
    report = pp.main([*flags, "--out", str(port_out)])
    want = json.loads(jax_out.read_text())
    got = json.loads(port_out.read_text())
    assert got.pop("device") == "cpu"
    assert got.pop("seconds") > 0.0 and got.pop("peak_memory_gb") is None
    assert pp.key_paths(got) == pp.key_paths(want)
    assert pp.key_paths(want) == pp.key_paths(pp.report_skeleton(["ramp"]))
    assert got["config"] == want["config"]
    assert got["nsamples"] == want["nsamples"]
    assert pp.key_paths(report) == pp.key_paths(got)
    for path in pp.key_paths(report):
        v = report
        for k in path:
            v = v[k]
        assert np.isfinite(v), path


def test_age_probe_trace_matches_the_jax_loop(warm):
    """`field_trace` (the plain rounds on the CPU) against the probe's
    loop written with the JAX package's internals, from one state: the
    water deposit total of every round."""
    _, fields = warm
    rounds = 24
    rain = np.zeros((N, N), np.float32)
    rain[10:14, 10:14] = 1.0
    p = jsoil.param_t()
    p.maxage = 128
    p.timeStep = 500.0
    st = jsoil.ErosionState(**{k: jnp.asarray(v) for k, v in fields.items()})
    t = jero._fluvial_terms(st.layers, jnp.asarray(rain), st.discharge,
                            st.momentum, st.albedo_surface, SCALE, p)
    Llen, A = t["Llen"], t["A"]
    accel = t["E_v"] / A + t["force"][:, None, None]
    rules = jero.make_fluvial_rules(p, Llen)
    bd = jero._birth_density(N, N)
    carried0 = [bd * t["E_w"], bd * t["E_m"], bd * t["E_v"][0],
                bd * t["E_v"][1], bd * t["E_a"][0], bd * t["E_a"][1],
                bd * t["E_a"][2]]
    fD = p.frictionFactor / 8.0
    rate_v = jnp.clip(-Llen * 0.125 * fD / (jero._EPS + st.discharge),
                      -jero._RATE_CLIP, 0.0)
    auxs = jco.as_stack((accel[0], accel[1], jnp.ones_like(st.discharge),
                         rate_v))
    sA = jco.as_stack(jero._build_cohort_state(bd, t["speed"], carried0,
                                               None))
    G = jnp.zeros((jco.n_deposits(sA.shape[0]), N, N))
    one = jax.jit(lambda s, g: jco.cohort_round(s, g, auxs, rules, Llen,
                                                jco.shift_push))
    want = []
    for _ in range(rounds):
        G0 = G
        sA, G = one(sA, G)
        want.append(float((G[0] - G0[0]).sum()))
    want = np.array(want)

    got, G_port = age_deficit_probe.field_trace(
        state_from_numpy(fields, "cpu"), torch.from_numpy(rain), SCALE,
        _port(p), rounds)
    assert got.shape == (rounds,)
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(G_port.numpy(), np.asarray(G), rtol=2e-5,
                               atol=1e-5 * float(np.abs(G).max()))
    assert np.abs(want[1:]).max() > 0.0


def test_residual_probe_runs_with_the_jax_keys():
    out = residual_probe.run(size=N, seeds=2, device="cpu")
    assert list(out) == ["field_vs_mc_corr", "mc_floor_corr", "field_total",
                         "mc_total"]
    assert all(np.isfinite(v) for v in out.values())
    assert out["field_total"] > 0.0 and out["mc_total"] > 0.0
