"""The port's trajectory against the JAX package's trajectory goldens
(tests/data/golden_traj128.npz, golden_traj256.npz, from
tools/gen_goldens.py), on the plain torch path on the CPU, at
tests/test_golden.py's tolerances: field statistics at rtol 5e-3 and the
16 x 16 block-mean fingerprint at rtol 1e-2 / atol 1e-3. The inputs are
the same: the port's noise equals the JAX package's bitwise, and the
field transports draw no random numbers."""

import os

import numpy as np
import pytest
import torch

import soillib_tpu_torch as soil

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _block_means(a, k):
    W, H = a.shape
    return np.asarray(a).reshape(W // k, k, H // k, k).mean(axis=(1, 3))


def _check_traj(n, steps, npz):
    g = np.load(os.path.join(DATA, npz))
    param = soil.ErosionParams()
    param.transportIterations = 16
    scale = (0.1, 0.1, 4.0)
    h = soil.noise((n, n), soil.noise_t(seed=5.0, ext=(float(n),) * 2),
                   device="cpu") * 0.5 + 2.0
    state = soil.ErosionState.zeros((n, n), height=h, device="cpu")
    state = soil.erode(state, scale, param, steps=steps)
    for name in ("height", "discharge", "sediment"):
        arr = getattr(state, name).numpy()
        stats = np.array([arr.mean(), arr.std(), np.abs(arr).max()])
        np.testing.assert_allclose(stats, g[f"{name}_stats"], rtol=5e-3,
                                   err_msg=name)
    for name in ("height", "discharge"):
        arr = getattr(state, name).numpy()
        np.testing.assert_allclose(
            _block_means(arr, n // 16), g[f"{name}_blocks"],
            rtol=1e-2, atol=1e-3, err_msg=f"{name} fingerprint",
        )


def test_erosion_trajectory_golden_128x30():
    _check_traj(128, 30, "golden_traj128.npz")


@pytest.mark.skipif(os.environ.get("SOIL_SLOW_TESTS") != "1",
                    reason="~3.5 min on CPU; set SOIL_SLOW_TESTS=1")
def test_erosion_trajectory_golden_256x100():
    _check_traj(256, 100, "golden_traj256.npz")
