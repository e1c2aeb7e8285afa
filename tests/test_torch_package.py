"""The PyTorch port's package contract: it imports no JAX, its entry points
do not fall back to the CPU, what it has not ported raises, and its CUDA
wrapper refuses what the kernel cannot take."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch.convert import state_from_numpy, state_to_numpy
from soillib_tpu_torch.models.erosion import make_fluvial_rules
from soillib_tpu_torch.ops import cohort

torch.set_num_threads(1)


def test_import_pulls_in_no_jax():
    """Importing the package and every one of its modules, examples and
    study harnesses pulls in neither JAX nor the JAX package (and runs
    none of them: the subprocess has a time limit)."""
    code = (
        "import importlib, pkgutil, sys, soillib_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    soillib_tpu_torch.__path__, 'soillib_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'soillib_tpu_torch.examples.multiscale' in names\n"
        "assert 'soillib_tpu_torch.io.mesh' in names\n"
        "for m in ('mesh', 'halo', 'erosion', 'ops', 'graph', 'particles'):\n"
        "    assert 'soillib_tpu_torch.parallel.' + m in names, m\n"
        "for m in ('erosion_pod', 'dem_mc_pod'):\n"
        "    assert 'soillib_tpu_torch.examples.' + m in names, m\n"
        "for m in ('parity', 'residual_probe', 'age_deficit_probe',\n"
        "          'scaling'):\n"
        "    assert 'soillib_tpu_torch.benchmarks.' + m in names, m\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'soillib_tpu' or m.startswith('soillib_tpu.')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_public_surface_matches_the_jax_package_but_the_queued_names():
    """Every name of the JAX package's `__all__` is exported by the port
    (none is queued any more), and `parallel` has the JAX package's
    `__all__`."""
    import soillib_tpu
    import soillib_tpu.parallel

    missing = set(soillib_tpu.__all__) - set(soil.__all__)
    assert missing == set()
    for name in soil.__all__:
        assert hasattr(soil, name), name
    assert sorted(soil.parallel.__all__) == sorted(
        soillib_tpu.parallel.__all__)
    for name in soil.parallel.__all__:
        assert hasattr(soil.parallel, name), name


# The parallel helpers whose arguments are torch's own (a process's mesh
# in place of JAX's mesh shape and axis names, the tensor dims to split,
# the group's transport and timeout): the port's parameter names.
_TORCH_ARGUMENTS = {
    "ShardHalo": ["mesh"],
    "exchange_axis": ["arr", "mesh", "mesh_axis", "axis", "fill", "radius"],
    "make_mesh": ["shape", "devices", "transport", "axis_names", "timeout"],
    "shard_field": ["arr", "mesh", "spec"],
}


def _parameter_names(obj):
    import inspect

    fn = obj.__init__ if isinstance(obj, type) else obj
    try:
        names = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None
    return [n for n in names if n != "self"]


def test_signatures_match_the_jax_package():
    """Every callable of both `__all__` lists takes the JAX package's
    parameter names, in order, but for the port's deliberate
    differences: a trailing `device=`, `generator=` for `key=` (a
    torch.Generator for a JAX key), and the parallel helpers' torch
    arguments (`_TORCH_ARGUMENTS`)."""
    import soillib_tpu
    import soillib_tpu.parallel

    diffs = []
    for jmod, tmod, torch_args in (
            (soillib_tpu, soil, {}),
            (soillib_tpu.parallel, soil.parallel, _TORCH_ARGUMENTS)):
        for name in jmod.__all__:
            want = _parameter_names(getattr(jmod, name))
            got = _parameter_names(getattr(tmod, name))
            if want is None or not callable(getattr(jmod, name)):
                continue
            if name in torch_args:
                want = torch_args[name]
            else:
                got = ["key" if n == "generator" else n for n in got
                       if n != "device"]
            if got != want:
                diffs.append((name, want, got))
    assert diffs == []


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        soil.ErosionState.zeros((8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        soil.ErosionSim((8, 8), (0.1, 0.1, 4.0))
    st = soil.ErosionState.zeros((8, 8), device="cpu")
    assert st.device.type == "cpu"


@pytest.mark.parametrize("field,value", [
    ("offsets", False), ("offstep", "stream"), ("offstep", False),
    ("vdist", "uniform"), ("xmom", True), ("perstream", True),
    ("node_rule", "sign"), ("node_rule", "cluster"),
])
def test_non_default_closure_raises(field, value):
    """Every closure variant runs (tests/test_torch_closures.py holds each
    against the JAX package); what raises is what the JAX package refuses
    too: the same variant with 3 nodes raises ValueError."""
    p = soil.ErosionParams()
    p.transportIterations = 2
    nodes = {"nodes": 4} if field == "node_rule" else {}
    p.closure = soil.CohortClosure(**{field: value}, **nodes)
    p.closureDebris = "same"
    st = soil.ErosionState.zeros((8, 8), device="cpu")
    out = soil.erode(st, (0.1, 0.1, 4.0), p)
    assert bool(torch.isfinite(out.discharge).all())
    p.closure = dataclasses.replace(p.closure, nodes=3)
    with pytest.raises(ValueError, match="nodes"):
        soil.erode(st, (0.1, 0.1, 4.0), p)


def test_particles_transport_method_runs():
    """transportMethod="particles" runs both Monte-Carlo estimators on the
    CPU and keeps the state finite; the transported fields are nonzero."""
    p = soil.ErosionParams()
    p.transportMethod = "particles"
    p.nSamples, p.maxage = 256, 12
    h = torch.linspace(0.0, 1.0, 64).reshape(8, 8)
    st = soil.ErosionState.zeros((8, 8), height=h, device="cpu")
    out = soil.erode(st, (0.1, 0.1, 4.0), p, steps=2)
    for k in ("height", "discharge", "momentum", "debris"):
        assert bool(torch.isfinite(getattr(out, k)).all()), k
    assert float(out.discharge.abs().max()) > 0.0


def test_field_static_erode_runs():
    """transportMethod="field-static" runs the linear sweep (plain rounds
    on the CPU, no kernel launch) and keeps the state finite."""
    from soillib_tpu_torch.ops import sweep

    p = soil.ErosionParams()
    p.transportMethod = "field-static"
    p.transportIterations = 4
    st = soil.ErosionState.zeros((12, 10), height=torch.rand((12, 10)),
                                 device="cpu")
    before = dict(sweep.sweep_launches)
    out = soil.erode(st, (0.1, 0.1, 4.0), p, steps=2)
    assert sweep.sweep_launches == before
    assert out.discharge.shape == (12, 10)
    assert bool(torch.isfinite(out.height).all())
    assert float(out.discharge.abs().max()) > 0.0


def test_sources_import_neither_jax_nor_the_jax_package():
    """No module of the port and not chip_smoke.py names jax or
    soillib_tpu in an import (the card's machine has no JAX)."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "soillib_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    pat = re.compile(r"^\s*(from|import)\s+(jax|soillib_tpu)(\.|\s|$)",
                     re.MULTILINE)
    bad = [str(f.relative_to(root)) for f in files
           if pat.search(f.read_text())]
    assert len(files) > 10 and bad == []


def test_every_kernel_source_is_built():
    """One library per csrc/*.cu; the six kernel sources of the port."""
    from soillib_tpu_torch import _native

    assert _native.sources() == ["cohort_round", "fp32_chain",
                                 "particle_rounds", "tile_accumulate",
                                 "trace_mark", "transport_sweep"]


def test_cpu_tensors_take_the_plain_rounds():
    """run_cohort on CPU tensors launches nothing; the kernel wrapper
    refuses CPU tensors instead of computing on them."""
    rules = make_fluvial_rules(soil.ErosionParams(), 0.14, albedo_on=False)
    st = torch.rand((14, 6, 5)) + 0.1
    aux = torch.ones((4, 6, 5))
    before = dict(cohort.cohort_round_launches)
    G = cohort.run_cohort(st, aux, rules, 3, 0.14)
    assert G.shape == (4, 6, 5) and bool(torch.isfinite(G).all())
    assert cohort.cohort_round_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cohort.cohort_round_cuda(st, aux, torch.zeros((4, 6, 5)), rules,
                                 0.14)


def test_state_round_trip():
    rng = np.random.default_rng(0)
    fields = state_to_numpy(soil.ErosionState.zeros((5, 7), device="cpu"))
    fields = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in fields.items()}
    back = state_to_numpy(state_from_numpy(fields, "cpu"))
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="missing"):
        state_from_numpy({"layers": fields["layers"]}, "cpu")


def test_params_aliases_and_snapshot():
    p = soil.param_t()
    p.bedShear = 0.5  # legacy alias of bedShearWater
    assert p.bedShearWater == 0.5
    q = soil.ErosionParams.from_frozen(p.freeze())
    assert q == p and q is not p
    with pytest.raises(AttributeError):
        p.notAParameter = 1.0
