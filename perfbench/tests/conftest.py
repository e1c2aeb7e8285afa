"""CPU tests of the benchmark harness (`python -m pytest perfbench/tests`
from the repository root). Tests that need the card carry the `cuda`
marker and skip without one."""

import json
import os
import shutil

import pytest

from perfbench import spec


@pytest.fixture
def tiny(tmp_path):
    """A copy of the harness's data folders with a 32 x 32 cell of each
    transport method ("tiny.field", "tiny.particles"), made only by adding
    files, and a BENCHMARK dict that names them. Returns (here, bench)."""
    here = tmp_path / "perfbench"
    for d in ("configs", "traffic", "limits", "metrics", "pipelines"):
        shutil.copytree(os.path.join(spec.HERE, d), here / d)
    cfg = spec.config("erosion-256")
    cfg.update(grid=[32, 32], scale=[0.625, 0.625, 4.0])
    cfg["terrain"]["ext"] = [32.0, 32.0]
    cfg["params"].update(maxage=24, nSamples=512)
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench = spec.benchmark()
    for method in ("field", "particles"):
        trf = spec.traffic("field64" if method == "field" else "particles")
        trf["params"]["transportIterations"] = 8 if method == "field" else 0
        trf["check"].update(within=3, window_samples=2)
        trf["warmup_s"] = 0
        (here / "traffic" / f"tiny-{method}.json").write_text(
            json.dumps(trf))
        lim = spec.limits("erosion-256.field64")
        (here / "limits" / f"tiny.{method}.json").write_text(json.dumps(lim))
        bench["workloads"].append(
            {"name": f"tiny.{method}", "config": "tiny",
             "traffic": f"tiny-{method}", "chips": 1, "why": "CPU test"})
        for m in bench["end_to_end"]:
            if m["name"] == "cell_steps_per_s.small":
                m["workloads"].append(f"tiny.{method}")
    return str(here), bench
