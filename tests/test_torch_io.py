"""The port's I/O (soillib_tpu_torch/io: tiff, geotiff, zip_save/zip_load)
and timer against the JAX package on the CPU: the same array and meta
give byte-identical GeoTIFF files, each package reads the other's files,
the zip checkpoint round-trips, and the timer keeps the reference's
units."""

import os
import time

import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.io.checkpoint import zip_load as jax_zip_load
from soillib_tpu.io.checkpoint import zip_save as jax_zip_save


@pytest.fixture
def arr():
    rng = np.random.default_rng(5)
    return rng.random((19, 23)).astype(np.float32)


def _meta(g):
    g.meta.scale = [0.5, 0.25, 1.0]
    g.meta.coords = [0, 0, 0, 100.0, 200.0, 0]
    g.meta.gdal_nodata = "-9999"
    g.meta.geoasciiparams = "WGS 84|"
    g.meta.keydir = [1, 1, 0, 1, 1024, 0, 1, 2]
    g.meta.params = [6378137.0]
    return g


def test_geotiff_write_is_byte_identical(tmp_path, arr):
    """The same array and meta written by either package: the same bytes
    (the array given to the port as a tensor)."""
    a, b = str(tmp_path / "port.tiff"), str(tmp_path / "jax.tiff")
    _meta(soil.geotiff(torch.from_numpy(arr))).write(a)
    _meta(jsoil.geotiff(arr)).write(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_each_package_reads_the_others_files(tmp_path, arr):
    a, b = str(tmp_path / "port.tiff"), str(tmp_path / "jax.tiff")
    _meta(soil.geotiff(arr)).write(a)
    _meta(jsoil.geotiff(arr * 2.0)).write(b)
    from_jax = soil.geotiff(b)
    from_port = jsoil.geotiff(a)
    np.testing.assert_array_equal(from_jax.numpy(), arr * 2.0)
    np.testing.assert_array_equal(from_port.numpy(), arr)
    for g in (from_jax, from_port):
        assert g.meta.scale == [0.5, 0.25, 1.0]
        assert g.meta.coords == [0, 0, 0, 100.0, 200.0, 0]
        assert g.meta.gdal_nodata == "-9999"
        assert g.meta.keydir == [1, 1, 0, 1, 1024, 0, 1, 2]
    # Plain TIFFs too, and the tensor view of what was read.
    soil.tiff(arr).write(a)
    np.testing.assert_array_equal(jsoil.tiff(a).numpy(), arr)
    t = soil.tiff(b)
    assert t.width == 23 and t.height == 19 and t.bits == 32
    cpu = t.tensor_on("cpu")
    assert cpu.dtype == torch.float32
    np.testing.assert_array_equal(cpu.numpy(), arr * 2.0)


def test_zip_roundtrip_across_packages(tmp_path):
    """zip_save / zip_load round-trip in the port (tensor fields), and the
    JAX package loads the port's zip and the port the JAX package's."""
    rng = np.random.default_rng(3)
    fields = {"height": rng.random((16, 12)).astype(np.float32),
              "discharge": rng.random((16, 12)).astype(np.float32)}
    pscale = (0.078, 0.078, 4.0)
    port = str(tmp_path / "port.zip")
    soil.util.zip_save(port, {k: torch.from_numpy(v)
                              for k, v in fields.items()}, pscale)
    for loaded in (soil.util.zip_load(port), jax_zip_load(port)):
        assert sorted(loaded) == sorted(fields)
        for k, v in fields.items():
            got, meta = loaded[k]
            np.testing.assert_array_equal(got, v)
            np.testing.assert_allclose(meta.scale, pscale, rtol=1e-7)
    ref = str(tmp_path / "jax.zip")
    jax_zip_save(ref, fields, pscale)
    for k, (got, _) in soil.util.zip_load(ref).items():
        np.testing.assert_array_equal(got, fields[k])
    # No temporary files are left beside the zips.
    assert sorted(os.listdir(tmp_path)) == ["jax.zip", "port.zip"]


def test_relief_shade_matches_jax():
    rng = np.random.default_rng(2)
    h = rng.random((12, 10)).astype(np.float32)
    n = rng.normal(size=(12, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        soil.util.relief_shade(torch.from_numpy(h), torch.from_numpy(n)),
        jsoil.util.relief_shade(h, n))


@pytest.mark.parametrize("unit,scale", [("ns", 1e9), ("us", 1e6),
                                        ("ms", 1e3), ("s", 1.0)])
def test_timer_units(unit, scale):
    """The reference's duration enumerators, `count` in the unit and
    `elapsed` in seconds; the same enumerator values as the JAX
    package's."""
    u = getattr(soil, unit)
    assert u == getattr(jsoil, unit)
    with soil.timer(u) as t:
        t.wait(torch.ones(4))
        time.sleep(0.02)
    assert t.elapsed >= 0.02
    assert t.count == int(t.elapsed * scale)
    with soil.timer() as t_default:
        pass
    assert t_default.count == int(t_default.elapsed * 1e3)


def test_profile_writes_a_chrome_trace(tmp_path):
    import json

    with soil.profile(str(tmp_path)) as prof:
        torch.ones(64).add_(1.0)
    with open(prof.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("add_" in e.get("name", "") for e in events)
