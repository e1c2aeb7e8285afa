"""BENCHMARK.json and the harness's data files: every name resolves, the
contract's limits on names, units and bounds hold, and a new cell,
configuration, mix and metric are found by adding files alone."""

import json
import os
import re

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_names_resolve():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    cfgs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert spec.config(c["name"])["reduced"] == c["reduced"]
    for cell in b["workloads"]:
        assert cell["config"] in cfgs and cell["chips"] == 1
        cfg = spec.config(cell["config"])
        pipe = spec.pipeline(spec.pipeline_name(cfg)).Pipeline
        lim = spec.limits(cell["name"])["limits"]
        assert list(lim) == list(pipe.NUMBERS)
        if spec.pipeline_name(cfg) == "erosion":
            p = spec.params(cfg, spec.traffic(cell["traffic"]))
            assert p["transportMethod"] in ("field", "particles")
            assert lim["passthrough"] == 0.0
        e2e = spec.metrics_of(b, cell["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert spec.metrics_of(b, cell["name"], True)
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_benchmark_contract_limits():
    b = spec.benchmark()
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = ([c["name"] for c in b["configs"]]
             + [c["name"] for c in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for text in ([c["why"] for c in b["workloads"] + b["configs"]]
                 + [c["source"] for c in b["configs"]]
                 + [m["layer"] for m in b["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text
    cells = {c["name"] for c in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    assert len(json.dumps(b)) <= 64 * 1024


def test_new_cell_found_by_adding_files(tiny, tmp_path):
    here, bench = tiny
    # A metric added as a file of its own, with no edit elsewhere.
    with open(os.path.join(here, "metrics", "steps_profiled.py"), "w") as f:
        f.write("def read(rec):\n    return float(rec['steps'])\n")
    bench["per_layer"].append(
        {"name": "steps_profiled", "unit": "steps", "better": "higher",
         "source": "device_trace", "layer": "Driver", "moves":
         "cell_steps_per_s", "workloads": ["tiny.field"]})
    cell = spec.cell(bench, "tiny.field")
    cfg = spec.config(cell["config"], here)
    trf = spec.traffic(cell["traffic"], here)
    assert cfg["grid"] == [32, 32]
    assert trf["params"]["transportIterations"] == 8
    assert spec.limits("tiny.field", here)["limits"]
    names = [m["name"] for m in spec.metrics_of(bench, "tiny.field", True)]
    assert "steps_profiled" in names and "particle_roofline_pct" not in names
    assert spec.reader("steps_profiled", here)({"steps": 3}) == 3.0
