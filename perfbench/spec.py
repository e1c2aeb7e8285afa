"""Finding a cell's files by name.

BENCHMARK.json, at the root of the checkout, names the cells; a cell
names its configuration and traffic mix. Each of these, each per-layer
metric and each pipeline is a file of its own in this folder:

    configs/<config>.json    the deployment: what its pipeline builds and
                             runs (for erosion: grid, scale, terrain,
                             state, parameters), and under "pipeline" the
                             name of that pipeline ("erosion" where the
                             key is absent)
    traffic/<traffic>.json   the mix: what the pipeline varies per cell
                             (for erosion: transport method and depth, how
                             the seed varies the terrain), the warm-up
                             time, the steps checked, the steps profiled
    limits/<cell>.json       the limit of each number the check compares
    metrics/<metric>.py      `read(record)`: the metric from a traced run's
                             record, or None where there is nothing to read;
                             a metric `<base>.<part>` without a file of its
                             own (the same quantity moving another
                             end-to-end metric) reads with `<base>`'s
    pipelines/<name>.py      `Pipeline(cfg, trf, seed, device)`: everything
                             of a run that belongs to one kind of
                             configuration: its inputs from the seed, the
                             program's set-up (an object with `step()`,
                             `state()`, `load(state)`, `work` a step and
                             the facts its readers read), the steps checked
                             after the window, the plain reference and the
                             control of a checked step, the check's numbers
                             and their gaps, and the program's counters
                             around the profiled steps

`run.py`, `check.py` and `control.py` are the same for every pipeline. A
new cell, configuration, mix, metric or pipeline is a new file and a new
entry in BENCHMARK.json; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The pipeline of a configuration that names none.
DEFAULT_PIPELINE = "erosion"


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[c['name'] for c in bench['workloads']]})")


def config(name: str, here: str = HERE) -> dict:
    return _load_json(os.path.join(here, "configs", f"{name}.json"))


def traffic(name: str, here: str = HERE) -> dict:
    return _load_json(os.path.join(here, "traffic", f"{name}.json"))


def limits(cell_name: str, here: str = HERE) -> dict:
    return _load_json(os.path.join(here, "limits", f"{cell_name}.json"))


def params(cfg: dict, trf: dict) -> dict:
    """The step's parameters as run: the configuration's, then the mix's."""
    p = dict(cfg["params"])
    p.update(trf["params"])
    return p


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's metrics (dicts of BENCHMARK.json): its end-to-end ones
    untraced, its per-layer ones traced. A metric with a `workloads` list
    belongs to those cells; one without to every cell that reports the
    end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def _load_module(kind: str, name: str, path: str):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, here: str = HERE):
    """The `read(record)` function of metrics/<metric>.py, or of
    metrics/<base>.py for a metric `<base>.<part>` that has no file."""
    path = os.path.join(here, "metrics", f"{metric}.py")
    if not os.path.exists(path) and "." in metric:
        return reader(metric.rsplit(".", 1)[0], here)
    return _load_module("metric", metric, path).read


def pipeline_name(cfg: dict) -> str:
    """The pipeline a configuration names, or DEFAULT_PIPELINE."""
    return cfg.get("pipeline", DEFAULT_PIPELINE)


def pipeline(name: str, here: str = HERE):
    """The module pipelines/<name>.py of the folder `here`; its class
    `Pipeline` is the pipeline."""
    path = os.path.join(here, "pipelines", f"{name}.py")
    return _load_module("pipeline", name, path)
