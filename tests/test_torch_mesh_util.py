"""The port's `mesh` (triangulation and PLY writers) and `util`
(`iter_tiff`, the plotting helpers) against the JAX package on the CPU.
On their numpy paths (both packages' native libraries switched off here)
the mesh's vertices and faces equal the JAX package's numpy
triangulation's and its files are the same bytes as the JAX package's
numpy writer's. The port's native path is held against its numpy path
in tests/test_torch_host_utils.py."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import soillib_tpu_torch as soil

jmesh = importlib.import_module("soillib_tpu.io.mesh")
pmesh = importlib.import_module("soillib_tpu_torch.io.mesh")
torch.set_num_threads(1)


@pytest.fixture
def jax_numpy_mesh(monkeypatch):
    """The JAX package's mesh on its numpy path (and the port's)."""
    monkeypatch.setattr(jmesh, "_native_triangulate", lambda h, s: None)
    monkeypatch.setattr(jmesh, "_native_ply", lambda *a, **k: False)
    monkeypatch.setattr(pmesh, "_native_triangulate", lambda h, s: None)
    monkeypatch.setattr(pmesh, "_native_ply", lambda *a: False)
    return jmesh.mesh


def _dem(shape, seed, holes):
    rng = np.random.default_rng(seed)
    h = (rng.random(shape) * 40.0).astype(np.float32)
    if holes:
        h[rng.random(shape) < 0.1] = np.nan
        h[2:5, 1] = np.nan
    return h


@pytest.mark.parametrize("shape,holes,scale", [
    ((13, 9), False, (1.0, 1.0, 1.0)),
    ((21, 17), True, (0.5, 2.0, 3.0)),
    ((4, 4), True, (30.0, 30.0, 1.0)),
])
def test_mesh_matches_jax(jax_numpy_mesh, tmp_path, shape, holes, scale):
    h = _dem(shape, sum(shape), holes)
    got = soil.mesh(torch.from_numpy(h), scale).center()
    want = jax_numpy_mesh(h, scale).center()
    assert got.vertices.dtype == np.float32 and got.faces.dtype == np.int32
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    for writer in ("write", "write_binary"):
        a, b = tmp_path / f"port.{writer}", tmp_path / f"jax.{writer}"
        assert getattr(got, writer)(str(a)) and getattr(want, writer)(str(b))
        assert a.read_bytes() == b.read_bytes(), writer


def test_empty_mesh_writes_a_header(jax_numpy_mesh, tmp_path):
    got, want = soil.mesh(), jax_numpy_mesh()
    got.write_binary(str(tmp_path / "a.ply"))
    want.write_binary(str(tmp_path / "b.ply"))
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()


def test_iter_tiff(tmp_path):
    for name in ("b.tiff", "a.tiff", "c.tiff"):
        soil.geotiff(np.zeros((2, 2), np.float32)).write(str(tmp_path / name))
    files = [f for f, _ in soil.util.iter_tiff(str(tmp_path))]
    assert files == ["a.tiff", "b.tiff", "c.tiff"]
    assert [f for f, _ in soil.util.iter_tiff(str(tmp_path),
                                              max_files=0)] == ["a.tiff"]
    one = str(tmp_path / "b.tiff")
    assert list(soil.util.iter_tiff(one)) == [("b.tiff", one)]
    with pytest.raises(RuntimeError, match="does not exist"):
        list(soil.util.iter_tiff(str(tmp_path / "missing")))


PLOTS = [
    ("plot_area", lambda a: ((a["area"],), {})),
    ("plot_dem", lambda a: ((a["h"],), {})),
    ("plot_flow", lambda a: ((a["flow"],), {})),
    ("plot_images", lambda a: (([a["h"], a["area"]],), {})),
    ("show_mass", lambda a: ((a["area"],), {})),
    ("show_height", lambda a: ((a["h"],), {})),
    ("show_normal", lambda a: ((a["h"], (1.0, 1.0, 2.0)),
                               {"device": "cpu"})),
    ("show_relief", lambda a: ((a["h"], (1.0, 1.0, 2.0)),
                               {"device": "cpu"})),
    ("show_discharge", lambda a: ((a["area"],), {})),
    ("show_layers", lambda a: ((a["layers"],), {"device": "cpu"})),
]


def _plot_inputs():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(np.cumsum(rng.random((24, 20)), 0)
                         .astype(np.float32))
    flow = soil.steepest(h, soil.d8)
    return {"h": h, "flow": flow, "area": soil.accumulate(flow, 1.0),
            "layers": torch.stack([h, torch.rand((24, 20)) * 1e-3])}


@pytest.mark.parametrize("name,args", PLOTS, ids=[n for n, _ in PLOTS])
def test_plot_helper_writes_a_png(tmp_path, name, args):
    import matplotlib.pyplot as plt

    a, kw = args(_plot_inputs())
    path = str(tmp_path / f"{name}.png")
    getattr(soil.util, name)(*a, show=False, save=path, **kw)
    plt.close("all")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_without_matplotlib_raises(monkeypatch):
    """Where matplotlib is missing (the card's machine) a helper raises
    ImportError and says how the examples skip their plots."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--out"):
        soil.util.show_height(np.zeros((4, 4)), show=False, save="x.png")
    assert not os.path.exists("x.png")
