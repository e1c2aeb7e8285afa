"""The port's distributed flow accumulation (`parallel.graph.accumulate`)
against the JAX package's and against the single-device methods, on the
CPU: 4 gloo ranks as a 2 x 2 mesh (one launch for the module;
tests/torch_parallel_ranks.py), the JAX package on a (2, 2) mesh of 4 of
conftest's 8 virtual devices, the same numpy terrain.

Tolerance rtol 1e-5 / atol 1e-4, tests/test_parallel.py's bar for this
op: the block contraction, the ring system and pointer doubling sum in
another order than one device does. Cases: d4 and d8, with and without a
decay field, a scalar source with a scalar decay, blocks of one 128^2
tile (64 x 96) and blocks of several ragged tiles (300 x 260: 150 x 130),
and the sharded steepest feeding the accumulate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu import parallel as jpar
from soillib_tpu_torch import parallel as par
from soillib_tpu_torch.parallel.graph import _exit_trace

from tests import torch_parallel_ranks as ranks

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def _problem(W, H, seed):
    """A filled tilted terrain (the JAX package fills it), its d4 and d8
    steepest graphs, rain and a decay field."""
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(W, H)) * 3.0
         + np.linspace(0, 5, W)[:, None]).astype(np.float32)
    h = np.array(jsoil.fill_depressions(jnp.asarray(h)))
    flows = {e: np.array(jsoil.steepest(jnp.asarray(h), e))
             for e in (soil.d4, soil.d8)}
    rain = (np.abs(rng.normal(size=(W, H))) + 0.1).astype(np.float32)
    decay = np.full((W, H), 0.98, np.float32)
    return h, flows, rain, decay


SMALL = _problem(64, 96, 13)
LARGE = _problem(300, 260, 5)
CASES = [
    ("small", "accumulate", dict(flows=SMALL[1], rain=SMALL[2],
                                 decay=SMALL[3])),
    ("large", "accumulate", dict(flows=LARGE[1], rain=LARGE[2],
                                 decay=LARGE[3])),
    ("pipeline", "accumulate_pipeline", dict(h=LARGE[0])),
]


@pytest.fixture(scope="module")
def got():
    return par.launch(ranks.run_cases, 4, transport="gloo",
                      devices=["cpu"] * 4, shape=(2, 2), args=(CASES,),
                      timeout=240)[0]


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh((2, 2),
                          devices=np.array(jax.devices()[:4]).reshape(2, 2))


def _close(a, b, msg):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("edge", [soil.d4, soil.d8])
def test_distributed_accumulate_matches_jax(got, jmesh, edge):
    """64 x 96 on 2 x 2: against JAX's distributed accumulate and JAX's
    single-device doubling, plain and decayed."""
    _, flows, rain, decay = SMALL
    f = jnp.asarray(flows[edge])
    g = got["small"]
    _close(g[f"plain{edge}"], jpar.graph.accumulate(
        f, jnp.asarray(rain), edge, mesh=jmesh), f"edge={edge}")
    _close(g[f"plain{edge}"], jsoil.accumulate(
        f, jnp.asarray(rain), edge, method="doubling"), f"edge={edge}")
    _close(g[f"decay{edge}"], jpar.graph.accumulate(
        f, jnp.asarray(rain), edge, mesh=jmesh, decay=jnp.asarray(decay)),
        f"decay edge={edge}")
    _close(g[f"decay{edge}"], jsoil.accumulate_decay(
        f, jnp.asarray(rain), jnp.asarray(decay), edge, method="doubling"),
        f"decay edge={edge}")


@pytest.mark.parametrize("edge", [soil.d4, soil.d8])
def test_distributed_accumulate_multi_tile_blocks(got, edge):
    """300 x 260 on 2 x 2 (150 x 130 blocks, each several ragged 128^2
    tiles of the tiled accumulator): against the port's single-device
    doubling, plain, decayed and with a scalar source and decay."""
    _, flows, rain, decay = LARGE
    f = torch.from_numpy(flows[edge])
    g = got["large"]
    _close(g[f"plain{edge}"], soil.accumulate(
        f, torch.from_numpy(rain), edge, method="doubling"), "plain")
    _close(g[f"decay{edge}"], soil.accumulate_decay(
        f, torch.from_numpy(rain), torch.from_numpy(decay), edge,
        method="doubling"), "decay")
    _close(g[f"scalar{edge}"], soil.accumulate_decay(
        f, 1.0, 0.9, edge, method="doubling"), "scalar")


def test_sharded_steepest_feeds_the_accumulate(got):
    """The sharded steepest graph equals the single-device one bitwise,
    and its distributed accumulation conserves unit rain: the roots
    receive every cell."""
    h = LARGE[0]
    flow = soil.steepest(torch.from_numpy(h), soil.d8).numpy()
    np.testing.assert_array_equal(got["pipeline"]["flow"], flow)
    area = got["pipeline"]["area"]
    _close(area, soil.accumulate(torch.from_numpy(flow), 1.0, soil.d8,
                                 method="doubling"), "area")
    np.testing.assert_allclose(area[flow < 0].sum(), h.size, rtol=1e-5)


def test_exit_trace_equals_the_one_hop_fixed_point():
    """Phase 2's pointer doubling gives the exit targets of the JAX
    package's one-hop fixed point exactly and its path weights to float
    rounding (products taken in another association)."""
    from soillib_tpu_torch.ops.graph_sweep import fixed_point
    from soillib_tpu_torch.ops.graph_tiled import _pull

    rng = np.random.default_rng(1)
    h = torch.from_numpy(np.asarray(jsoil.fill_depressions(jnp.asarray(
        (rng.normal(size=(40, 36)) * 2).astype(np.float32)))))
    slot = soil.direction(h, soil.d8)
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (40, 36)).astype(np.float32))
    # Cut the edges leaving column 19, as a block edge there would.
    cross = (slot >= 0) & (torch.arange(40)[:, None] == 19)
    lslot = torch.where(cross, -1, slot).to(torch.int32)
    X0 = torch.where(cross, torch.arange(40 * 36, dtype=torch.int32)
                     .reshape(40, 36), -1)
    D0 = torch.where(slot < 0, 0.0, w)
    inner = ~cross & (slot >= 0)

    def step(c):
        X, D = c
        return (torch.where(inner, _pull(X, slot, soil.d8, -1), X0),
                torch.where(inner, w * _pull(D, slot, soil.d8, 0.0), D0))

    Xw, Dw = fixed_point(step, (X0, D0), 40 * 36)
    X, D = _exit_trace(lslot, X0, D0, w, soil.d8)
    np.testing.assert_array_equal(X.numpy(), Xw.numpy())
    np.testing.assert_allclose(D.numpy(), Dw.numpy(), rtol=1e-6)
