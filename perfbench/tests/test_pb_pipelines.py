"""The pipeline seam: a configuration names its pipeline
(`pipelines/<name>.py`), and a pipeline of another kind than erosion, with
its configuration, mix, limits, cell and metric, runs through
`run.run_cell` when added as files alone. On the CPU at 32 x 32; also the
particle kernels' roofline share on synthetic records, and its byte
yardstick against the plain reference's round."""

import inspect
import json
import os
import re

import pytest

from perfbench import run, spec, yardstick
from perfbench.reference import step as reference

# A toy pipeline: explicit diffusion of a seeded field, fixed at its edges.
# The program steps it with torch's slicing and counts its steps; the
# reference is a plain numpy loop over the cells; the control is the
# reference in float16. `{fault}` is a line of the program's step.
TOY = '''
import numpy as np
import torch

from perfbench import check

STEPS = {{"all": 0}}


class Program:
    def __init__(self, u, k):
        self.u, self.k = u, k
        self.work = u.numel()
        self.record = {{"cells": u.numel()}}

    def step(self):
        u = self.u
        new = u.clone()
        new[1:-1, 1:-1] = u[1:-1, 1:-1] + self.k * (
            u[2:, 1:-1] + u[:-2, 1:-1] + u[1:-1, 2:] + u[1:-1, :-2]
            - 4 * u[1:-1, 1:-1])
        {fault}
        self.u = new
        STEPS["all"] += 1

    def state(self):
        return {{"u": self.u}}

    def load(self, fields):
        self.u = fields["u"].clone()


class Pipeline:
    NUMBERS = ("field", "total")

    def __init__(self, cfg, trf, seed, device):
        self.shape = tuple(cfg["grid"])
        self.k = float(trf["params"]["k"])
        self.seed, self.device = int(seed), device

    def inputs(self):
        g = torch.Generator(device=self.device).manual_seed(
            self.seed % (1 << 63))
        return {{"u": torch.rand(self.shape, generator=g,
                                device=self.device)}}

    def setup(self, inputs):
        return Program(inputs["u"].clone(), self.k)

    def extra_inputs(self, state):
        return [{{"u": 1.0 - state["u"]}}]

    def reference(self, inp, i, dtype=np.float32):
        u = inp["u"].cpu().numpy().astype(dtype)
        out = u.copy()
        k = dtype(self.k)
        for x in range(1, u.shape[0] - 1):
            for y in range(1, u.shape[1] - 1):
                out[x, y] = u[x, y] + k * (
                    u[x + 1, y] + u[x - 1, y] + u[x, y + 1] + u[x, y - 1]
                    - dtype(4) * u[x, y])
        return {{"u": torch.from_numpy(out.astype(np.float32)).to(
            inp["u"].device)}}

    def control(self, inp, i):
        return self.reference(inp, i, np.float16)

    @staticmethod
    def gaps(inp, prog, ref):
        return {{"u": check.gap(prog["u"], ref["u"])
                / max(check.scale(ref["u"]), 1e-30),
                "sum": abs(float(prog["u"].double().sum()
                                 - ref["u"].double().sum()))}}

    @staticmethod
    def numbers(gaps):
        return {{"field": gaps["u"], "total": gaps["sum"]}}

    @staticmethod
    def counters():
        return {{"toy_steps": dict(STEPS)}}
'''

READER = '''
def read(rec):
    n = rec["counters"].get("toy_steps", {}).get("all", 0)
    return n / rec["steps"] if n else None
'''


@pytest.fixture
def toy(tiny):
    """The tiny harness copy with, as new files alone, the toy pipeline
    (and a broken twin: half the field left unchanged), a configuration and
    a cell of each, a mix, limits, an end-to-end rate and a per-layer
    metric that reads the toy's counter. Returns (here, bench)."""
    here, bench = tiny
    half = "new[: new.shape[0] // 2] = u[: u.shape[0] // 2]"
    pipelines = {"toy": "", "toy_broken": half}
    for name, fault in pipelines.items():
        with open(os.path.join(here, "pipelines", f"{name}.py"), "w") as f:
            f.write(TOY.format(fault=fault))
        cfg = name.replace("_", "-")
        with open(os.path.join(here, "configs", f"{cfg}.json"), "w") as f:
            json.dump({"pipeline": name, "grid": [32, 32], "reduced": []}, f)
        with open(os.path.join(here, "limits", f"{cfg}.diffuse.json"),
                  "w") as f:
            json.dump({"limits": {"field": 1e-6, "total": 1e-3}}, f)
        bench["workloads"].append(
            {"name": f"{cfg}.diffuse", "config": cfg, "traffic": "diffuse",
             "chips": 1, "why": "CPU test"})
    with open(os.path.join(here, "traffic", "diffuse.json"), "w") as f:
        json.dump({"params": {"k": 0.2}, "warmup_s": 0,
                   "check": {"first_step": True, "window_samples": 2,
                             "within": 3},
                   "profile_steps": 2}, f)
    with open(os.path.join(here, "metrics", "toy_steps_per_step.py"),
              "w") as f:
        f.write(READER)
    cells = ["toy.diffuse", "toy-broken.diffuse"]
    bench["end_to_end"].append(
        {"name": "cell_steps_per_s.toy", "unit": "cell-steps/s",
         "better": "higher", "bound": 0.1, "source": "device_trace",
         "workloads": cells})
    bench["per_layer"].append(
        {"name": "toy_steps_per_step", "unit": "steps", "better": "lower",
         "source": "program_counter", "layer": "Toy",
         "moves": "cell_steps_per_s.toy", "workloads": cells})
    return here, bench


def _run(toy, name, traced=False, seed=2**31 + 9):
    here, bench = toy
    return run.run_cell(spec.cell(bench, name), bench, seed, 0.2, traced,
                        device="cpu", here=here)


def test_a_pipeline_added_as_files_runs_correct(toy):
    out = _run(toy, "toy.diffuse")
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert list(out["checks"]) == ["field", "total"]
    assert out["checks"]["field"][1] == 1e-6
    assert set(out["metrics"]) == {"cell_steps_per_s.toy", "peak_mem_gb",
                                   "setup_s"}
    # The first step, the two sampled from the window and the extra step.
    steps = out["info"]["steps_checked"]
    assert len(steps) == 4 and steps[0] == 0
    assert steps[-1] == out["info"]["steps_run"]
    assert set(out["info"]["field_gaps"]) == {"u", "sum"}


def test_a_broken_step_of_an_added_pipeline_is_not_correct(toy):
    out = _run(toy, "toy-broken.diffuse")
    assert out["correct"] is False and out["failed"] > 0
    assert "field" in out["info"]["over_limit"]
    assert list(out)[-1] == "checks"


def test_an_added_pipeline_reports_its_counter_traced(toy):
    out = _run(toy, "toy.diffuse", traced=True)
    assert out["correct"] is True
    # Two profiled steps, each counted once by the toy program.
    assert out["metrics"]["toy_steps_per_step"] == {"value": 1.0,
                                                    "unit": "steps"}
    assert out["info"]["traced"]["counters"] == {"toy_steps": {"all": 2}}
    # The profiled steps precede the extra step, which comes last.
    assert out["info"]["steps_checked"][-1] == out["info"]["steps_run"] + 2


def test_the_control_of_an_added_pipeline_fails_its_limits(toy):
    here, bench = toy
    cfg = spec.config("toy", here)
    pipe = spec.pipeline(spec.pipeline_name(cfg), here).Pipeline(
        cfg, spec.traffic("diffuse", here), 3, "cpu")
    inp = pipe.inputs()
    nums = pipe.numbers(pipe.gaps(inp, pipe.control(inp, 0),
                                  pipe.reference(inp, 0)))
    lim = spec.limits("toy.diffuse", here)["limits"]
    assert nums["field"] > lim["field"], nums


def test_a_configuration_without_pipeline_is_erosion():
    assert spec.pipeline_name({"grid": [8, 8]}) == "erosion"
    assert spec.pipeline_name({"pipeline": "toy"}) == "toy"
    b = spec.benchmark()
    for c in b["configs"]:
        cfg = spec.config(c["name"])
        assert "pipeline" not in cfg
        mod = spec.pipeline(spec.pipeline_name(cfg))
        assert mod.__file__ == os.path.join(spec.HERE, "pipelines",
                                            "erosion.py")
    keys = mod.Pipeline.counters()
    assert set(keys) == {"cohort_rounds", "particle_rounds"}


def test_the_generic_harness_names_nothing_of_erosion():
    words = set(reference.FIELDS) | {"ErosionSim", "ErosionState",
                                     "erode_step", "soillib_tpu_torch"}
    for name in ("run.py", "check.py", "control.py"):
        with open(os.path.join(spec.HERE, name)) as f:
            src = f.read()
        code = re.sub(r'""".*?"""|#[^\n]*', "", src, flags=re.S)
        found = {w for w in words if re.search(rf"\b{w}\b", code)}
        assert not found, (name, found)


def _rec(ops, rounds):
    return {"device_ops": ops, "host_spans": [], "steps": 2, "t0": 0.0,
            "t1": 1.0, "counters": {"particle_rounds": rounds}}


def test_particle_roofline_reads_a_synthetic_record():
    read = spec.reader("particle_roofline_pct")
    ops = [("void (anonymous namespace)::particle_rounds_kernel<0>"
            "(ParticleParams, ParticleArrays)", 0.0, 2e-4, "kernel"),
           ("void (anonymous namespace)::particle_rounds_kernel<1>"
            "(ParticleParams, ParticleArrays)", 1e-3, 1.1e-3, "kernel"),
           ("void at::native::elementwise_kernel<128, 2>(x)", 2e-3, 3e-3,
            "kernel")]
    rounds = {"fluvial": 1_900_000, "debris": 230_000}
    want = 100 * (1_900_000 * 48 + 230_000 * 40) / 3.35e12 / 3e-4
    assert read(_rec(ops, rounds)) == pytest.approx(want)
    assert 0 < read(_rec(ops, rounds)) <= 100
    # No kernel, no rounds counted, or an estimator outside the yardstick:
    # nothing to read.
    assert read(_rec(ops[2:], rounds)) is None
    assert read(_rec(ops, {})) is None
    assert read({"device_ops": ops, "steps": 2, "counters": {}}) is None
    assert read(_rec(ops, {"other": 5})) is None
    names = [m["name"] for m in spec.metrics_of(
        spec.benchmark(), "erosion-256.particles", True)]
    assert "particle_roofline_pct" in names
    assert "scatter_ms_per_step" not in names
    for cell in ("erosion-256.field64", "erosion-4096.field32"):
        assert "particle_roofline_pct" not in [
            m["name"] for m in spec.metrics_of(spec.benchmark(), cell, True)]


@pytest.mark.parametrize("kind,estimator", [
    ("fluvial", reference._fluvial_particles),
    ("debris", reference._debris_particles)])
def test_particle_bytes_follow_the_plain_round(kind, estimator):
    """The yardstick's fields gathered at `ind` are those the reference's
    `advance` reads, and its deposits the channels of its `sel`."""
    src = inspect.getsource(estimator)
    advance = src[src.index("def advance"):]
    gathered = set(re.findall(r"(\w+)\[ind\]", advance))
    sel = re.search(r"sel = torch\.tensor\(\(([^)]*)\)", src).group(1)
    deposited = len([s for s in sel.split(",") if s.strip()])
    assert yardstick.PARTICLE_FIELDS[kind] == (len(gathered), deposited)
    assert yardstick.particle_round_bytes(kind) == 4 * (
        len(gathered) + deposited)
