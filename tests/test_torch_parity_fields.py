"""The field half of the transport-parity harness at the harness's own
depth: the JAX harness (`benchmarks/parity.py`, imported by path) makes a
warm state from its noise terrain at 64^2 (`make_terrains`, `make_state`
with 8 warm field steps, maxage 128: 126 cohort rounds a solve, JAX on
the CPU), `convert.state_from_numpy` carries it to the port, and one
`transport_fluvial` and one `transport_debris` with method="field" and
the default closure run in both packages from it.

This separates the two halves of a field-vs-MC metric: if the port's
field solve equals JAX's here, a disagreement of the port's parity record
with JAX's (the 256^2 records in soillib_tpu_torch/benchmarks/records/)
lies in the Monte-Carlo half, whose draws differ (torch's against
threefry), and is held to the MC's split-half noise instead.

Tolerances (the ROADMAP's bar for 126 nonlinear rounds: the
tests/test_golden.py tolerances):
* per cell, rtol 1e-2 with an absolute floor of 1e-3 of the field's
  largest magnitude (the golden block-mean fingerprint's bar);
* each field's mean, standard deviation and largest magnitude at rtol
  5e-3 (the golden field statistics' bar);
* the harness's own `metrics(port_field, jax_field)`: correlation
  >= 1 - 1e-5 on every output field.
About 25 s in one process, most of it the JAX side compiling.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu_torch.benchmarks import compare_records
from soillib_tpu_torch.benchmarks import parity as pp
from soillib_tpu_torch.convert import params_from_frozen, state_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, MAXAGE, WARM = 64, 128, 8
SCALE = (0.078, 0.078, 4.0)
RTOL, ATOL_FRAC = 1e-2, 1e-3
STATS_RTOL = 5e-3
MIN_CORR = 1.0 - 1e-5
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


def _jax_param():
    """The JAX harness's `main` parameters at MAXAGE."""
    p = jsoil.ErosionParams()
    p.maxage = MAXAGE
    p.transportIterations = MAXAGE - 2
    p.nSamples = N * N * 16
    p.timeStep = 500.0
    return p


def _solve_both():
    """{phase: (port outputs, JAX outputs, field names)} from one
    JAX-made warm state, every output as numpy."""
    p = _jax_param()
    terr = jp.make_terrains(N, ("noise",))["noise"]
    st = jp.make_state(terr, WARM, SCALE, p)
    fields = {k: np.array(getattr(st, k)) for k in STATE_FIELDS}
    js = jsoil.ErosionState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ps = state_from_numpy(fields, "cpu")
    pport = params_from_frozen(p.freeze())
    out = {}
    for phase, jfn, pfn, names in (
            ("fluvial", jsoil.transport_fluvial, soil.transport_fluvial,
             pp.FLUVIAL_FIELDS),
            ("debris", jsoil.transport_debris, soil.transport_debris,
             pp.DEBRIS_FIELDS)):
        if phase == "fluvial":
            jargs = (js.layers, js.rainfall, js.discharge, js.mass,
                     js.momentum, js.albedo_surface, SCALE)
            pargs = (ps.layers, ps.rainfall, ps.discharge, ps.mass,
                     ps.momentum, ps.albedo_surface, SCALE)
        else:
            jargs = (js.layers, js.debris, js.debris_momentum,
                     js.albedo_surface, SCALE)
            pargs = (ps.layers, ps.debris, ps.debris_momentum,
                     ps.albedo_surface, SCALE)
        want = jfn(*jargs, p, method="field")
        got = pfn(*pargs, pport, method="field")
        assert len(got) == len(want) == len(names)
        out[phase] = ([g.numpy() for g in got],
                      [np.asarray(w) for w in want], names)
    return out


@pytest.fixture(scope="module")
def solves():
    return _solve_both()


CASES = [(phase, i) for phase, names in (("fluvial", pp.FLUVIAL_FIELDS),
                                          ("debris", pp.DEBRIS_FIELDS))
         for i in range(len(names))]


@pytest.mark.parametrize("phase,i", CASES,
                         ids=[f"{ph}-{n}" for ph, names in (
                             ("fluvial", pp.FLUVIAL_FIELDS),
                             ("debris", pp.DEBRIS_FIELDS)) for n in names])
def test_field_solve_matches_jax_at_the_harness_depth(solves, phase, i):
    got, want, names = solves[phase]
    g, w = got[i], want[i]
    name = f"{phase} {names[i]}"
    assert g.shape == w.shape and g.dtype == np.float32, name
    assert np.isfinite(g).all(), name
    scale = float(np.abs(w).max())
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL_FRAC * scale,
                               err_msg=name)
    for stat in (np.mean, np.std, lambda a: np.abs(a).max()):
        np.testing.assert_allclose(stat(g.astype(np.float64)),
                                   stat(w.astype(np.float64)),
                                   rtol=STATS_RTOL, err_msg=name)
    m = pp.metrics(torch.from_numpy(g), torch.from_numpy(np.array(w)))
    assert m["corr"] >= MIN_CORR, (name, m)


def test_the_warm_state_carries_signal(solves):
    """Not a comparison of zeros: the warm state's field solves move
    water, sediment and momentum."""
    got, want, _ = solves["fluvial"]
    for i in range(3):  # discharge, mass, momentum
        assert np.abs(want[i]).max() > 0.0 and want[i].std() > 0.0, i


# ---------------------------------------------------------------------------
# The committed parity records: the port on the card against the JAX
# harness on the CPU, each pair with the same flags.

RECORDS = os.path.join(REPO, "soillib_tpu_torch", "benchmarks", "records")
PAIRS = {"48": ("parity_48.json", "parity_48_jax_cpu.json"),
         "256": ("parity_256_reduced.json", "parity_256_jax_cpu.json")}


def _record(name):
    with open(os.path.join(RECORDS, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("size", sorted(PAIRS))
def test_the_card_and_jax_records_agree_within_the_mc_noise(size):
    """Every single-phase correlation of the card's record within
    compare_records.CORR_NOISE of the JAX CPU record's where both MCs
    carry signal; the same configuration in both."""
    card, jax_cpu = (_record(n) for n in PAIRS[size])
    assert card["config"] == jax_cpu["config"]
    assert card["nsamples"] == jax_cpu["nsamples"]
    assert card["device"].startswith("NVIDIA ")
    terrains = [t for t, v in card.items() if isinstance(v, dict)
                and "cold" in v]
    # Two regimes of 4 fluvial and 3 debris fields a terrain.
    assert len(compare_records.single_phase_rows(card, jax_cpu)) == (
        14 * len(terrains))
    assert compare_records.outside_noise(card, jax_cpu) == []


@pytest.mark.parametrize("which", ["card", "jax"])
def test_both_256_records_show_the_default_closure_s_gap(which):
    """At 256^2 the default closure's warm noise momentum barely
    correlates with the MC's and the coupled suspended mass sits an
    order of magnitude off it, in JAX's record as in the card's: the
    closure's behaviour at this size, not the port's."""
    rec = _record(PAIRS["256"][which == "jax"])
    assert abs(rec["noise"]["warm"]["fluvial"]["momentum"]["corr"]) < 0.05
    assert rec["noise"]["warm"]["fluvial"]["momentum"]["mc_selfcorr"] > 0.99
    for terrain in ("noise", "steep"):
        mass = rec[terrain]["coupled"]["mass"]
        assert mass["field_vs_mc_relmean"] > 10.0
        assert mass["mc_vs_mc_relmean"] < 0.1
