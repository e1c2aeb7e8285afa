"""The port's albedo generators (`albedo_stratum`, `albedo_layer`,
`albedo_discharge`) against the JAX package on the CPU at rtol 2e-6,
channel-first (3, W, H)."""

import jax.numpy as jnp
import numpy as np
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil

torch.set_num_threads(1)

W, H = 31, 26


def _fields(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s).astype(np.float32)
    return dict(uplift=f(W, H), layers=np.stack([f(W, H) * 2.0,
                                                 f(W, H) * 0.05]),
                discharge=rng.normal(size=(W, H)).astype(np.float32),
                albedo=f(3, W, H), albedo_sediment=f(3, W, H))


def _close(got, want):
    assert got.shape == (3, W, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=0.0)


def test_albedo_stratum_matches_jax():
    fl = _fields(0)
    p, jp = soil.ErosionParams(), jsoil.ErosionParams()
    p.uplift = jp.uplift = 0.7
    args = ((0.9, 0.6, 0.3), (0.2, 0.3, 0.5), 1.5, 0.05)
    got = soil.albedo_stratum(torch.from_numpy(fl["uplift"]),
                              torch.from_numpy(fl["layers"]),
                              (0.1, 0.1, 4.0), p, *args)
    want = jsoil.albedo_stratum(jnp.asarray(fl["uplift"]),
                                jnp.asarray(fl["layers"]),
                                (0.1, 0.1, 4.0), jp, *args)
    _close(got, want)
    # Both colors occur: the stripes are resolved at this frequency.
    assert len(np.unique(got.numpy()[0])) == 2


def test_albedo_layer_matches_jax():
    fl = _fields(1)
    for shift in (0.1, 0.9):
        got = soil.albedo_layer(torch.from_numpy(fl["albedo"]),
                                torch.from_numpy(fl["albedo_sediment"]),
                                torch.from_numpy(fl["layers"]), 40.0, shift)
        want = jsoil.albedo_layer(jnp.asarray(fl["albedo"]),
                                  jnp.asarray(fl["albedo_sediment"]),
                                  jnp.asarray(fl["layers"]), 40.0, shift)
        _close(got, want)


def test_albedo_discharge_matches_jax():
    fl = _fields(2)
    got = soil.albedo_discharge(torch.from_numpy(fl["albedo"]),
                                torch.from_numpy(fl["discharge"]),
                                (0.1, 0.3, 0.6), 2.5, 0.8)
    want = jsoil.albedo_discharge(jnp.asarray(fl["albedo"]),
                                  jnp.asarray(fl["discharge"]),
                                  (0.1, 0.3, 0.6), 2.5, 0.8)
    _close(got, want)
