"""The port's fractal noise (soillib_tpu_torch/ops/noise.py) against the
FastNoiseLite goldens and against the JAX package on the CPU.

Tolerances: the goldens at tests/test_noise.py's atol 1e-6; the JAX
package bitwise (both evaluate the same float32 operations in the same
order, and the integer hashes wrap identically), for compat True and
False.
"""

import os

import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu_torch.ops import noise as port_noise

_GOLDENS = os.path.join(os.path.dirname(__file__), "data",
                        "fastnoiselite_goldens.npz")

# tests/test_noise.py's configurations of the goldens.
_GOLDEN_CONFIGS = {
    "erosion_gpu_256": dict(shape=(256, 256), ext=(256.0, 256.0), seed=3.0),
    "default_ext_64x48": dict(shape=(64, 48), ext=(512.0, 512.0), seed=3.0),
    "odd_params": dict(shape=(32, 32), ext=(17.3, 29.1), seed=-2.5,
                       octaves=5, frequency=1.7, gain=0.45, lacunarity=2.3),
    "single_octave": dict(shape=(32, 32), ext=(32.0, 32.0), seed=0.0,
                          octaves=1),
}

# Three parameter sets on a 64 x 48 grid.
_PARAMS = [
    dict(),
    dict(seed=3.0, ext=(64.0, 48.0)),
    dict(seed=-1.5, octaves=4, frequency=2.3, gain=0.5, lacunarity=1.9,
         ext=(17.0, 23.0)),
]


@pytest.mark.parametrize("name", sorted(_GOLDEN_CONFIGS))
def test_noise_matches_fastnoiselite_goldens(name):
    cfg = dict(_GOLDEN_CONFIGS[name])
    shape = cfg.pop("shape")
    want = np.load(_GOLDENS)[name]
    got = soil.noise(shape, soil.noise_t(**cfg), device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(shape)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("k", range(len(_PARAMS)))
def test_noise_matches_jax_bitwise(compat, k):
    got = soil.noise((64, 48), soil.noise_t(compat=compat, **_PARAMS[k]),
                     device="cpu").numpy()
    want = np.asarray(jsoil.noise((64, 48),
                                  jsoil.noise_t(compat=compat, **_PARAMS[k])))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_os2_grad_decode_matches_table():
    """The arithmetic gradient decode reproduces the 64-entry table."""
    gi = torch.arange(64, dtype=torch.int64)
    dec = np.stack([c.numpy() for c in
                    port_noise._os2_grad_components(gi)], -1)
    np.testing.assert_array_equal(dec, port_noise._OS2_GRADS)


def test_unsigned_hash_matches_uint32():
    """`mul_u32` and the unsigned `_hash3` equal numpy's wrapping uint32
    arithmetic, on values across the int32 range."""
    rng = np.random.default_rng(0)
    a = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64)
    b = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64)
    c = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64)
    u = (a & 0xFFFFFFFF).astype(np.uint32)
    with np.errstate(over="ignore"):
        want = u * np.uint32(0x85EBCA6B)
    got = port_noise.mul_u32(torch.from_numpy(a) & 0xFFFFFFFF, 0x85EBCA6B)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)

    def hash3(i, j, k, seed):
        with np.errstate(over="ignore"):
            h = (i.astype(np.uint32) * np.uint32(0x8DA6B343)
                 + j.astype(np.uint32) * np.uint32(0xD8163841)
                 + k.astype(np.uint32) * np.uint32(0xCB1AB31F)
                 + np.uint32(seed) * np.uint32(0x9E3779B9))
            h ^= h >> np.uint32(15)
            h *= np.uint32(0x85EBCA6B)
            h ^= h >> np.uint32(13)
            h *= np.uint32(0xC2B2AE35)
            h ^= h >> np.uint32(16)
        return h

    for seed in (7, 1020, 7098):
        got = port_noise._hash3(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(c), seed)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      hash3(a.astype(np.int32),
                                            b.astype(np.int32),
                                            c.astype(np.int32), seed))


def test_noise_entry_defaults_to_the_card():
    """The entry point runs on the card unless the caller asks for the
    CPU: without a GPU, the default raises rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soil.noise((8, 8))
