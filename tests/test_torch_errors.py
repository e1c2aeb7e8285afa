"""The port's twin of tests/test_errors.py: wrong inputs fail loudly, with
the exception type the JAX package raises for each. Sharded cases run on a
1 x 1 CPU mesh (`par.make_mesh(devices=["cpu"])`); where a check needs a
larger mesh it runs on rank 0's view of one (`par.Mesh`), which places
blocks without a process group."""

import numpy as np
import pytest
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch import parallel as par
from soillib_tpu_torch.core.device import seeded_generator

torch.set_num_threads(1)


def _ones(*shape):
    return torch.ones(shape, dtype=torch.float32)


def test_invalid_edge_enum():
    h = _ones(8, 8)
    with pytest.raises(ValueError):
        soil.steepest(h, 42)
    with pytest.raises(ValueError):
        soil.direction(h, -1)


def test_unknown_transport_method():
    st = soil.ErosionState.zeros((8, 8), height=_ones(8, 8), device="cpu")
    with pytest.raises(ValueError):
        soil.transport_fluvial(
            st.layers, st.rainfall, st.discharge, st.mass, st.momentum,
            st.albedo_surface, (0.1, 0.1, 1.0), soil.ErosionParams(),
            method="magic",
        )


def test_unknown_accumulate_method():
    h = _ones(8, 8)
    flow = soil.steepest(h, soil.d8)
    with pytest.raises(ValueError):
        soil.accumulate(flow, h, soil.d8, method="nope")


def test_sharded_erosion_rejects_particles():
    mesh = par.make_mesh(devices=["cpu"])
    p = soil.ErosionParams()
    p.transportMethod = "particles"
    with pytest.raises(ValueError):
        par.make_sharded_erode_fn(mesh, (0.1, 0.1, 1.0), p)


def test_layout_seam_fails_loudly():
    """Channel-layout misuse (the dem_mc_pod regression class) raises a
    layout-naming error, not a read of garbage W/H."""
    mesh = par.make_mesh(devices=["cpu"])
    W = H = 8
    bad_flow = torch.zeros((W, 2, H))  # channel-first by mistake
    src = _ones(W, H)
    dec = torch.zeros((W, H))
    with pytest.raises(ValueError, match="channel-LAST"):
        par.solve_particles_sharded(bad_flow, src, dec, (1.0, 1.0), 64,
                                    seeded_generator("cpu"), mesh)
    with pytest.raises(ValueError, match="channel-LAST"):
        soil.solve_uniform(bad_flow, src, dec, (1.0, 1.0))
    # A mismatched source shape also names the convention.
    good_flow = torch.zeros((W, H, 2))
    with pytest.raises(ValueError, match="W, H"):
        par.solve_particles_sharded(good_flow, _ones(H, 4), dec, (1.0, 1.0),
                                    64, seeded_generator("cpu"), mesh)


@pytest.mark.parametrize("estimator", ["fluvial", "debris"])
@pytest.mark.parametrize("field", ["layers", "momentum"])
def test_fluvial_sharded_rejects_channel_last_state(estimator, field):
    """The sharded erosion estimators check the state's layouts as the
    JAX package's do (its case is the fluvial estimator's layers)."""
    mesh = par.make_mesh(devices=["cpu"])
    st = soil.ErosionState.zeros((8, 8), height=_ones(8, 8), device="cpu")
    p = soil.ErosionParams()
    p.nSamples = 64
    bad = getattr(st, field).movedim(0, -1)  # (W, H, 2) by mistake
    st = st.replace(**{field: bad})
    with pytest.raises(ValueError, match="channel-FIRST"):
        if estimator == "fluvial":
            par.fluvial_particles_sharded(
                st.layers, st.rainfall, st.discharge, st.momentum,
                st.albedo_surface, (0.5, 0.5, 2.0), p,
                seeded_generator("cpu"), mesh)
        else:
            par.debris_particles_sharded(
                st.layers, st.debris, st.momentum, st.albedo_surface,
                (0.5, 0.5, 2.0), p, seeded_generator("cpu"), mesh)


def test_sharded_particles_return_channel_last_flux():
    """On a 1 x 1 mesh the sharded estimators' flux is the JAX package's
    (W, H, C), the single-device estimator's channels moved last."""
    from soillib_tpu_torch.models import erosion as ero
    from soillib_tpu_torch.testing import birth_draws, injected_births

    mesh = par.make_mesh(devices=["cpu"])
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.uniform(1.0, 2.0, (12, 10)).astype(np.float32))
    st = soil.ErosionState.zeros((12, 10), height=h, device="cpu")
    p = soil.ErosionParams()
    p.nSamples = 64
    p.maxage = 8
    scale = (0.5, 0.5, 2.0)
    with injected_births(birth_draws(64, 2, 1)):
        F, dropped = par.fluvial_particles_sharded(
            st.layers, st.rainfall, st.discharge, st.momentum,
            st.albedo_surface, scale, p, seeded_generator("cpu"), mesh)
    with injected_births(birth_draws(64, 2, 1)):
        ref = ero._fluvial_particles(
            st.layers, st.rainfall, st.discharge, st.momentum,
            st.albedo_surface, scale, p, seeded_generator("cpu"))
    assert dropped == 0
    assert tuple(F.shape) == (12, 10, 7)
    np.testing.assert_array_equal(
        F.numpy(), ref.reshape(7, 12, 10).permute(1, 2, 0).numpy())


def test_distributed_accumulate_rejects_indivisible_grid():
    """A 10 x 10 grid on a 2 x 4 mesh. The port's distributed accumulate
    takes blocks, which `shard_field` places, so the check is there."""
    mesh = par.Mesh((2, 4), 0, "cpu", None)
    h = _ones(10, 10)  # 10 % 4 != 0
    flow = soil.steepest(h, soil.d8)
    with pytest.raises(ValueError, match="not divisible"):
        par.graph.accumulate(par.shard_field(flow, mesh), 1.0, soil.d8,
                             mesh=mesh)


def test_param_typo_rejected_but_aliases_work():
    p = soil.ErosionParams()
    with pytest.raises(AttributeError):
        p.suspenssionRateFluvial = 1.0
    p.critSlope = 0.4               # legacy alias
    assert p.critSlopeBedrock == 0.4
    with pytest.raises(AttributeError):
        _ = p.doesNotExist


def test_missing_tiff_file():
    with pytest.raises(FileNotFoundError):
        soil.tiff("/nonexistent/file.tif")


def test_halo_radius_exceeds_block():
    """A block narrower than the requested halo fails with the clear
    message, not a garbage exchange (the JAX case's (4, 2) blocks)."""
    mesh = par.make_mesh(devices=["cpu"])
    halo = par.ShardHalo(mesh)
    with pytest.raises(ValueError, match="halo radius"):
        halo.crop(halo.pad(_ones(4, 2), 0.0, radius=4), 4)


def test_one_by_one_grid():
    """Degenerate 1x1 grids flow nowhere but do not crash."""
    h = _ones(1, 1)
    assert int(soil.steepest(h, soil.d8)[0, 0]) == -1
    a = soil.accumulate(soil.steepest(h, soil.d8), h, soil.d8,
                        method="doubling")
    assert float(a[0, 0]) == 1.0
    out = soil.fill_depressions(h)
    assert float(out[0, 0]) == 1.0
