"""What the harness loads, checked in fresh processes by whole top-level
module names: the harness and a whole CPU run load neither JAX nor the
JAX package (whose name the port's begins with), and the reference loads
nothing of the port either."""

import json
import os
import subprocess
import sys

from perfbench import spec

PROBE = """
import sys, json
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body):
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program_and_no_jax():
    mods = _top_level("import perfbench.reference.step, "
                      "perfbench.reference.rng, perfbench.check, "
                      "perfbench.terrain")
    assert not mods & {"jax", "jaxlib", "flax", "soillib_tpu",
                       "soillib_tpu_torch"}


def test_a_run_loads_no_jax():
    body = (
        "from perfbench.tests import conftest\n"
        "import pathlib, tempfile, inspect\n"
        "from perfbench import run\n"
        "tmp = pathlib.Path(tempfile.mkdtemp())\n"
        "here, bench = inspect.unwrap(conftest.tiny)(tmp)\n"
        "cell = [c for c in bench['workloads'] if c['name'] == "
        "'tiny.field'][0]\n"
        "out = run.run_cell(cell, bench, 5, 0.3, False, device='cpu', "
        "here=here)\n"
        "assert out['correct'], out\n"
        "assert run.forbidden_modules() == []\n")
    mods = _top_level(body)
    assert "soillib_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "soillib_tpu"}
