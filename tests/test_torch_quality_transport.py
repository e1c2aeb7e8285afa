"""The port's fluvial transport with the quality closure
`CohortClosure(nodes=4, colors=8)` against the JAX package on the CPU, at
tests/test_cohort_colors.py's rtol 1e-4 / atol 1e-6. (Apart from
tests/test_torch_quality.py because the JAX reference compiles the
32-ensemble round for about a minute.)
"""

import jax.numpy as jnp
import numpy as np
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil

torch.set_num_threads(1)

QUALITY = dict(nodes=4, colors=8)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _fluvial_args(n, seed):
    """Inputs of transport_fluvial on a noise terrain, for both packages."""
    h = np.asarray(jsoil.noise((n, n), jsoil.noise_t(seed=seed,
                                                     ext=(n, n))))
    st = jsoil.ErosionState.zeros((n, n), height=1.0 + 0.3 * h)
    keys = ("layers", "rainfall", "discharge", "mass", "momentum",
            "albedo_surface")
    arrays = [np.asarray(getattr(st, k)) for k in keys]
    return arrays


def test_transport_fluvial_quality_matches_jax():
    """transport_fluvial with CohortClosure(nodes=4, colors=8) at 24^2,
    4 rounds."""
    arrays = _fluvial_args(24, 2.0)
    p = soil.ErosionParams()
    p.transportIterations = 4
    p.closure = soil.CohortClosure(**QUALITY)
    jp = jsoil.ErosionParams()
    jp.transportIterations = 4
    jp.closure = jsoil.CohortClosure(**QUALITY)
    scale = (0.1, 0.1, 1.0)
    got = soil.transport_fluvial(*[_t(a) for a in arrays], scale, p)
    want = jsoil.transport_fluvial(*[jnp.asarray(a) for a in arrays], scale,
                                   jp)
    for g, w, name in zip(got, want,
                          ("discharge", "mass", "momentum", "albedo")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
