"""The port's pod examples (`soillib_tpu_torch.examples.erosion_pod`,
`dem_mc_pod`) with `--virtual 4` (4 gloo CPU ranks, a 2 x 2 mesh) at
small sizes: they print the JAX examples' lines, keep their fields
finite, and the Monte-Carlo one agrees with the single-device estimators
drawn from the same generators (tests/test_parallel.py's bars: the
particle set is the same, the deposit order is not)."""

import re

import numpy as np
import torch

from soillib_tpu_torch.core.device import seeded_generator
from soillib_tpu_torch.examples import dem_mc_pod, erosion_pod
from soillib_tpu_torch.models import erosion as ero
from soillib_tpu_torch.ops import transport

torch.set_num_threads(1)


def test_erosion_pod_virtual_ranks(capsys):
    ms = erosion_pod.main(["--virtual", "4", "--res", "32", "--steps", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "mesh: 2x2 (4 devices, 4 processes)"
    assert re.fullmatch(r"2 steps at 32x32: [0-9.]+ ms/step, [0-9.]+ M "
                        r"cell-steps/s across 4 devices", lines[1]), lines
    assert ms > 0.0


def _corr(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def test_dem_mc_pod_virtual_ranks(capsys, tmp_path):
    out_path = tmp_path / "mc.npz"
    out = dem_mc_pod.main(["--virtual", "4", "--res", "32", "--out",
                           str(out_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "mesh: 2x2 (4 devices)"
    assert re.fullmatch(r"uniform MC: 16384 particles in [0-9.]+s, dropped "
                        r"0, mean flux [0-9.]+", lines[1]), lines
    assert re.fullmatch(r"fluvial MC: [0-9.]+s, dropped 0, water flux mean "
                        r"[0-9.]+", lines[2]), lines
    assert lines[3] == f"wrote {out_path}"
    saved = np.load(out_path)
    np.testing.assert_array_equal(saved["uniform"], out["uniform"])
    assert saved["fluvial"].shape == (32, 32, 7)

    flow, source, decay, state = dem_mc_pod.problem((32, 32), "cpu")
    N = 16 * 32 * 32
    G = transport._solve_particles(flow, source, decay, (0.5, 0.5), N,
                                   seeded_generator("cpu", 0), 64).numpy()
    assert _corr(out["uniform"], G) >= 0.999
    np.testing.assert_allclose(out["uniform"].sum(), G.sum(), rtol=1e-4)
    F = ero._fluvial_particles(
        state.layers, state.rainfall, state.discharge, state.momentum,
        state.albedo_surface, (0.5, 0.5, 2.0), dem_mc_pod.fluvial_params(N),
        seeded_generator("cpu", 1)).reshape(7, 32, 32).numpy()
    got = out["fluvial"]  # (W, H, 7), channel-last as the JAX package's
    for c in (0, 1, 2, 3):
        if F[c].std() == 0.0:  # no mass on a state at rest: both zero
            np.testing.assert_array_equal(got[..., c], F[c])
        else:
            assert _corr(got[..., c], F[c]) >= 0.99, c
    np.testing.assert_allclose(got[..., 0].sum(), F[0].sum(), rtol=5e-3)
