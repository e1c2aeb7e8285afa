"""The port's flagship example (soillib_tpu_torch/examples/erosion.py) on
the CPU: its CLI at a tiny size writes erosion.zip, whose fields equal an
ErosionSim run of the same configuration, bitwise."""

import os
import subprocess
import sys

import numpy as np

import soillib_tpu_torch as soil
from soillib_tpu_torch.examples import erosion as example

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_run(res, steps):
    res2 = (res, res)
    pscale = (20.0 / res, 20.0 / res, 4.0)
    h = soil.noise(res2, soil.noise_t(seed=3.0, ext=res2), device="cpu")
    st = soil.ErosionState.zeros(res2, height=h, device="cpu")
    sim = soil.ErosionSim(res2, pscale, example.make_param(), state=st)
    sim.step(steps)
    return sim.state, pscale


def test_example_cli_writes_the_sim_result(tmp_path):
    """`python -m soillib_tpu_torch.examples.erosion --res 32 --steps 2
    --report 2 --device cpu` as a subprocess."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "soillib_tpu_torch.examples.erosion", "--res",
         "32", "--steps", "2", "--report", "2", "--device", "cpu", "--out",
         str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "steps    2/2:" in proc.stdout and "ms/step" in proc.stdout
    path = tmp_path / "erosion.zip"
    assert path.exists()
    loaded = soil.util.zip_load(str(path))
    want, pscale = _reference_run(32, 2)
    for name in ("height", "sediment", "discharge"):
        arr, meta = loaded[name]
        np.testing.assert_array_equal(arr, getattr(want, name).numpy())
        np.testing.assert_allclose(meta.scale, pscale, rtol=1e-7)


def test_example_main_reports_each_block(tmp_path):
    run = example.main(["--res", "16", "--steps", "3", "--report", "2",
                        "--device", "cpu", "--out", str(tmp_path)])
    assert len(run["ms_per_step"]) == 2
    assert run["zip"] == os.path.join(str(tmp_path), "erosion.zip")
    assert os.path.exists(run["zip"])
    want, _ = _reference_run(16, 3)
    np.testing.assert_array_equal(run["sim"].state.height.numpy(),
                                  want.height.numpy())
