"""The port's examples (soillib_tpu_torch/examples/) on the CPU at 16-48^2,
in process through `main(argv)` and once as a subprocess CLI: each returns
its fields, which equal direct calls of the ops; dem_multiflow with
injected uniforms equals the JAX example's member means (rtol 2e-5: the
accumulations sum in another order), tiff_merge's raster the JAX example's
output on the same tiles."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu_torch.examples import (
    dem_condition,
    dem_multiflow,
    dem_process,
    multiscale,
    tiff_merge,
    tiff_mesh,
    tiff_normal,
    tiff_relief,
    tiff_view,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def demdir(tmp_path_factory):
    """Two adjacent 32^2 GeoTIFF tiles (world-referenced), as
    tests/test_examples.py writes them for tiff_merge."""
    d = tmp_path_factory.mktemp("dems")
    rng = np.random.default_rng(0)
    for i in range(2):
        arr = rng.random((32, 32), dtype=np.float32) * 40.0
        g = soil.geotiff(arr)
        g.meta.scale = [1.0, 1.0, 1.0]
        g.meta.coords = [0, 0, 0, 32.0 * i, 0.0, 0.0]
        g.write(str(d / f"tile{i}.tiff"))
    return str(d)


def test_dem_process_fields_equal_the_ops():
    run = dem_process.main(["--res", "40", "--device", "cpu", "--out", ""])
    assert sorted(run["ms"]) == sorted([
        "fill_depressions", "steepest", "accumulate", "accumulate_decay",
        "gradient", "solve_uniform"])
    h = soil.noise((40, 40), soil.noise_t(seed=2.0), device="cpu") * 400.0
    filled = soil.fill_depressions(h)
    flow = soil.steepest(filled, soil.d8)
    rain = torch.ones_like(h)
    grad = soil.gradient(filled, (90.0, 90.0))
    want = {
        "height": filled, "flow": flow,
        "area": soil.accumulate(flow, rain, soil.d8),
        "decayed": soil.accumulate_decay(flow, rain,
                                         torch.full_like(h, 0.9999), soil.d8),
        "gradient": grad,
        "discharge": soil.solve_uniform(
            dem_process.velocity_of(grad), rain, torch.full_like(h, 0.001),
            (90.0, 90.0)),
    }
    for k, v in want.items():
        assert run[k].device.type == "cpu", k
        torch.testing.assert_close(run[k], v, rtol=0.0, atol=0.0,
                                   msg=k)
    assert float(run["discharge"].abs().max()) > 0.0


def test_dem_process_particles_runs():
    """--particles solves with solve_uniform(method="particles", seed=0)
    after the same flow pipeline (the same seed: bitwise); the fields
    before the solve are the field run's."""
    argv = ["--res", "16", "--device", "cpu", "--out", ""]
    run = dem_process.main(argv + ["--particles"])
    field = dem_process.main(argv)
    for k in ("height", "flow", "area", "decayed", "gradient"):
        assert torch.equal(run[k], field[k]), k
    h = run["height"]
    want = soil.solve_uniform(
        dem_process.velocity_of(run["gradient"]), torch.ones_like(h),
        torch.full_like(h, 0.001), (90.0, 90.0), method="particles", seed=0)
    assert torch.equal(run["discharge"], want)
    assert bool(torch.isfinite(want).all()) and float(want.max()) > 0.0


def test_dem_condition_drains_every_interior_cell():
    run = dem_condition.main(["--res", "48", "--device", "cpu", "--out", ""])
    assert run["pits_before"] > 0 and run["pits_after"] == 0
    assert bool((run["filled"] >= run["height"]).all())
    want = soil.accumulate(soil.steepest(run["filled"], soil.d8),
                           torch.ones_like(run["filled"]), soil.d8)
    torch.testing.assert_close(run["area"], want, rtol=0.0, atol=0.0)


def test_dem_multiflow_matches_the_jax_member_means():
    """K = 6 members in batches of 4 (a full and a partial batch), each
    with injected uniforms; the JAX side runs the JAX example's batch
    structure on the same uniforms."""
    K, batch, T, res = 6, 4, 10.0, 32
    u = np.random.default_rng(3).random((K, res, res)).astype(np.float32)
    height, _ = dem_process.load_or_synthesize(None, res, 7.0, "cpu")
    got = dem_multiflow.multiflow(height, K, T, batch, torch.from_numpy(u))
    h = jnp.asarray(height.numpy())
    rain = jnp.ones_like(h)
    total = jnp.zeros_like(h)
    for b in range(0, K, batch):
        k = min(batch, K - b)
        areas = [jsoil.accumulate(
            jsoil.random_weighted(h, jsoil.d8, T=T, u=jnp.asarray(u[m])),
            rain, jsoil.d8) for m in range(b, b + k)]
        total = total + jnp.stack(areas).mean(axis=0) * k
    want = np.asarray(total / K)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    # Without u the members draw from random_weighted(seed=member).
    run = dem_multiflow.main(["--res", str(res), "--K", "2", "--batch", "2",
                              "--T", str(T), "--device", "cpu", "--out", ""])
    drawn = run["multiflow"]
    torch.testing.assert_close(run["height"], height, rtol=0.0, atol=0.0)
    mean = torch.stack([soil.accumulate(soil.random_weighted(
        height, soil.d8, seed=m, T=T), torch.ones_like(drawn),
        soil.d8) for m in range(2)]).mean(dim=0)
    want = (torch.zeros_like(mean) + mean * 2) / 2   # total += mean * k
    torch.testing.assert_close(drawn, want, rtol=0.0, atol=0.0)


def test_multiscale_writes_a_loadable_zip(tmp_path):
    run = multiscale.main(["--levels", "16:1,24:1", "--device", "cpu",
                           "--out", str(tmp_path)])
    assert run["levels"] == [((16, 16), 1), ((24, 24), 1)]
    assert len(run["ms_per_step"]) == 2
    assert run["zip"] == os.path.join(str(tmp_path), "multiscale.zip")
    loaded = soil.util.zip_load(run["zip"])
    assert sorted(loaded) == ["discharge", "height", "sediment"]
    for name, (arr, meta) in loaded.items():
        np.testing.assert_array_equal(arr,
                                      getattr(run["state"], name).numpy())
        np.testing.assert_allclose(meta.scale, (20.0 / 24, 20.0 / 24, 4.0),
                                   rtol=1e-7)
    skipped = multiscale.main(["--levels", "16:1", "--device", "cpu",
                               "--out", ""])
    assert skipped["zip"] is None
    assert multiscale.DEFAULT_LEVELS == [((128, 128), 2048),
                                         ((256, 256), 4),
                                         ((1000, 1000), 4)]


def test_tiff_merge_matches_the_jax_example(demdir, tmp_path, monkeypatch):
    from examples import tiff_merge as jax_tiff_merge

    out = str(tmp_path / "port.tiff")
    run = tiff_merge.main([demdir, "--pscale", "2.0", "--out", out,
                           "--device", "cpu"])
    ref = str(tmp_path / "jax.tiff")
    monkeypatch.setattr(sys, "argv", ["tiff_merge.py", demdir, "--pscale",
                                      "2.0", "--out", ref])
    jax_tiff_merge.main()
    want = soil.geotiff(ref)
    got = soil.geotiff(out)
    assert got.meta.scale == want.meta.scale == run["scale"]
    np.testing.assert_array_equal(np.isnan(got.numpy()),
                                  np.isnan(want.numpy()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), run["merged"].numpy())
    skipped = tiff_merge.main([demdir, "--pscale", "2.0", "--out", "",
                               "--device", "cpu"])
    assert skipped["path"] is None


def test_tiff_view_relief_normal_mesh(demdir, tmp_path):
    view = tiff_view.main([demdir, "--out", str(tmp_path / "view")])
    assert [f for f, _ in view["images"]] == ["tile0.tiff", "tile1.tiff"]
    assert sorted(os.listdir(tmp_path / "view")) == ["tile0.tiff.png",
                                                     "tile1.tiff.png"]
    h = soil.geotiff(os.path.join(demdir, "tile0.tiff")).tensor_on("cpu")
    relief = tiff_relief.main([demdir, "--out", "", "--device", "cpu"])
    np.testing.assert_array_equal(
        relief["reliefs"][0][1],
        soil.util.relief_shade(h, soil.normal(h, (1.0, 1.0, 1.0))))
    normal = tiff_normal.main([demdir, "--out", str(tmp_path / "n"),
                               "--device", "cpu"])
    torch.testing.assert_close(normal["normals"][0][1],
                               soil.normal(h, (1.0, 1.0, 1.0)),
                               rtol=0.0, atol=0.0)
    assert len(os.listdir(tmp_path / "n")) == 2
    ply = str(tmp_path / "m.ply")
    mesh = tiff_mesh.main([os.path.join(demdir, "tile0.tiff"), ply])
    assert mesh["path"] == ply and len(mesh["mesh"].faces) == 2 * 31 * 31
    header = open(ply, "rb").read(200)
    assert header.startswith(b"ply\nformat binary_little_endian 1.0\n")


def test_examples_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dem_process.main(["--res", "16", "--out", ""])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multiscale.main(["--levels", "16:1"])


def test_example_cli_runs_as_a_subprocess(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    png = str(tmp_path / "cond.png")
    proc = subprocess.run(
        [sys.executable, "-m", "soillib_tpu_torch.examples.dem_condition",
         "--res", "32", "--device", "cpu", "--out", png],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "interior pits:" in proc.stdout and "-> 0" in proc.stdout
    assert os.path.exists(png)
