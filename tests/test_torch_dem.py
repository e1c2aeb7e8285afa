"""The PyTorch port's DEM workload and the `field-static` erosion transport
against the JAX package on the CPU.

The DEM workload is the reference's `example/dem_process.py` as the JAX
package runs it (examples/dem_process.py): fill_depressions -> steepest ->
accumulate + accumulate_decay -> gradient -> solve_uniform. Graphs and the
fill compare bitwise, accumulations at rtol 1e-5, the transport solve at
the sweep kernel bar (rtol 2e-6, atol 1e-5 of the field's scale). The
pipeline golden (tests/test_golden.py::test_dem_pipeline_golden) is held
at its own tolerances. One field-static transport solve compares
elementwise at the multi-round bar of tests/test_torch_erosion.py; the
coupled field-static steps at the golden trajectory rtol of 1e-3.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu.models.simulation import erode_step as jax_erode_step
from soillib_tpu_torch.convert import state_from_numpy, state_to_numpy
from soillib_tpu_torch.models.simulation import erode_step
from tests.test_golden import DATA, _block_means
from tests.test_torch_erosion import SCALE, _close, _params, _state_fields

torch.set_num_threads(1)


def _dem_process(lib, height, scale, device_kw):
    """examples/dem_process.py's pipeline through package `lib`."""
    filled = lib.fill_depressions(height, **device_kw)
    flow = lib.steepest(filled, lib.d8, **device_kw)
    rain = np.ones(height.shape, np.float32)
    area = lib.accumulate(flow, rain, lib.d8, **device_kw)
    decayed = lib.accumulate_decay(flow, rain,
                                   np.full(height.shape, 0.9999, np.float32),
                                   lib.d8, **device_kw)
    grad = np.asarray(lib.gradient(filled, scale, **device_kw))
    velocity = -grad / np.maximum(
        np.linalg.norm(grad, axis=-1, keepdims=True), 1e-6)
    evap = np.full(height.shape, 0.001, np.float32)
    discharge = lib.solve_uniform(velocity.astype(np.float32), rain, evap,
                                  scale, **device_kw)
    return [np.asarray(a) for a in (filled, flow, area, decayed, grad,
                                    discharge)]


def test_dem_process_pipeline_matches_jax():
    shape, scale = (300, 290), (90.0, 90.0)
    rng = np.random.default_rng(2)
    h = np.asarray(jsoil.noise(shape, jsoil.noise_t(seed=2.0))) * 400.0
    h = (h + 0.05 * rng.normal(size=shape)).astype(np.float32)
    want = _dem_process(jsoil, h, scale, {})
    got = _dem_process(soil, h, scale, {"device": "cpu"})
    names = ("filled", "flow", "area", "decayed", "gradient", "discharge")
    for name, g, w in zip(names[:2], got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_allclose(got[5], want[5], rtol=2e-6,
                               atol=1e-5 * np.abs(want[5]).max())
    # Unit rain, no decay: what reaches the roots is every cell's rain.
    roots = got[1] < 0
    np.testing.assert_allclose(got[2][roots].astype(np.float64).sum(),
                               h.size, rtol=1e-6)


def test_dem_pipeline_golden():
    """Port twin of tests/test_golden.py::test_dem_pipeline_golden: the
    stored DEM (read with the JAX package's GeoTIFF reader) -> fill ->
    steepest -> accumulate_decay, against the stored golden."""
    g = np.load(os.path.join(DATA, "golden_pipeline.npz"))
    r = jsoil.geotiff()
    r.read(os.path.join(DATA, "golden_dem.tif"))
    dem = np.array(r.tensor, np.float32)

    filled = soil.fill_depressions(dem, device="cpu")
    flow = soil.steepest(filled, soil.d8)
    acc = soil.accumulate_decay(flow, torch.ones(dem.shape), 0.9, soil.d8)

    np.testing.assert_allclose((filled.numpy() - dem).sum(),
                               g["fill_delta_sum"], rtol=1e-4)
    assert int((flow.numpy() < 0).sum()) == int(g["n_roots"])
    acc_np = acc.numpy()
    np.testing.assert_allclose(acc_np.mean(), g["acc_mean"], rtol=1e-4)
    np.testing.assert_allclose(acc_np.max(), g["acc_max"], rtol=1e-4)
    np.testing.assert_allclose(_block_means(acc_np, 8), g["acc_blocks"],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("albedo", [True, False])
def test_transport_fluvial_field_static_matches_jax(albedo):
    fl = _state_fields(5)
    p, jp = _params()
    p.trackAlbedo = jp.trackAlbedo = albedo
    keys = ("layers", "rainfall", "discharge", "mass", "momentum",
            "albedo_surface")
    got = soil.transport_fluvial(
        *[torch.from_numpy(fl[k]) for k in keys], SCALE, p,
        method="field-static")
    want = jsoil.transport_fluvial(*[jnp.asarray(fl[k]) for k in keys],
                                   SCALE, jp, method="field-static")
    assert float(np.abs(np.asarray(want[1])).max()) > 0.0  # sediment moved
    for name, g, w in zip(("discharge", "mass", "momentum", "albedo"),
                          got, want):
        _close(g, w, name)


def test_erode_field_static_matches_jax():
    """Three coupled steps with transportMethod="field-static" (fluvial:
    the linear sweep; debris: the cohort solve), elementwise at the golden
    rtol of 1e-3."""
    fl = _state_fields(6)
    p, jp = _params()
    p.transportMethod = jp.transportMethod = "field-static"
    out = state_from_numpy(fl, "cpu")
    for _ in range(3):
        out = erode_step(out, SCALE, p)
    out = state_to_numpy(out)
    ref = jsoil.ErosionState(**{k: jnp.asarray(v) for k, v in fl.items()})
    step = jax.jit(lambda s: jax_erode_step(s, SCALE, jp))
    for _ in range(3):
        ref = step(ref)
    for f in dataclasses.fields(ref):
        want = np.asarray(getattr(ref, f.name))
        got = out[f.name]
        if f.name == "albedo_debris":
            # A ratio of deposits (tests/test_torch_erosion.py).
            got, want = got * out["debris"], want * np.asarray(ref.debris)
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f.name)
