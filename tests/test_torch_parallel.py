"""The port's sharded execution (`soillib_tpu_torch.parallel`) against the
JAX package's and against the port's single-device ops, on the CPU.

The port runs on 4 gloo CPU ranks as a 2 x 2 mesh (one launch for the
module, fed every case; tests/torch_parallel_ranks.py is the ranks'
side), the JAX package on a (2, 2) mesh of 4 of conftest's 8 virtual
devices, with the same numpy inputs from a seed. The cases and
tolerances are tests/test_parallel.py's: bitwise for the halo, the
graphs and the overlap schedule; rtol 1e-6 for the stencils and the
solve; rtol 1e-4 / atol 1e-5 for one coupled step; integrals and
correlations for three steps. The port's sharded ops also equal its own
single-device ops bitwise (computed in rank 0, with the ranks' thread
count), and a 1 x 1 mesh equals the single-device step bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu import parallel as jpar
from soillib_tpu_torch import parallel as par
from soillib_tpu_torch.convert import (
    params_from_frozen,
    state_from_numpy,
    state_to_numpy,
)

from tests import torch_parallel_ranks as ranks

torch.set_num_threads(1)

SCALE3 = (0.5, 0.7, 2.0)
SCALE2 = (0.5, 0.7)
ESCALE = (0.08, 0.08, 4.0)
STEP_FIELDS = ("layers", "discharge", "mass", "momentum", "debris",
               "debris_momentum", "albedo_surface")


def _rng(seed):
    return np.random.default_rng(seed)


def _height(W=32, H=48, seed=7):
    return (_rng(seed).normal(size=(W, H)) * 3.0).astype(np.float32)


def _terrain(W, H, seed=0):
    return (2.0 + 0.02 * _rng(seed).normal(size=(W, H))).astype(np.float32)


def _state_fields(h):
    return state_to_numpy(soil.ErosionState.zeros(h.shape, height=_t(h),
                                                  device="cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _params(iters, closure=None, tol=0.0):
    """JAX ErosionParams and the port's frozen copy (the ranks import no
    JAX objects)."""
    p = jsoil.ErosionParams()
    p.transportIterations = iters
    if closure is not None:
        from soillib_tpu.ops.cohort import CohortClosure

        p.closure = CohortClosure(**closure)
    if tol:
        p.transportTol = tol
    return p, params_from_frozen(p.freeze()).freeze()


def _flow_problem(W, H, seed):
    r = _rng(seed)
    flow = r.normal(size=(W, H, 2)).astype(np.float32)
    source = np.abs(r.normal(size=(W, H))).astype(np.float32)
    decay = np.full((W, H), 0.05, np.float32)
    return flow, source, decay


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    return jpar.make_mesh((2, 2),
                          devices=np.array(jax.devices()[:4]).reshape(2, 2))


CASES = {}


def _case(name, fn, **kw):
    CASES[name] = (name, fn, kw)
    return kw


H0 = _height()
H2 = _rng(3).normal(size=(64, 128)).astype(np.float32)
U = _rng(11).random((32, 48), dtype=np.float32)
_case("halo", "halo", x=H0)
_case("stencils", "stencils", h=H0, h2=H2, scale2=SCALE2, scale3=SCALE3,
      sigma=4.0)
_case("graphs", "graphs", h=H0, u=U, seed=5, offset=9, T=2.0)
# 24 x 40 on 2 x 2: 12 x 20 blocks, narrower than HALO_K (one round a
# pass); 64 x 96: 32 x 48 blocks, the K-blocked passes.
_case("solve_round", "solve", **dict(zip(
    ("flow", "source", "decay"), _flow_problem(24, 40, 1))),
    scale=SCALE2, iterations=40)
_case("solve_k", "solve", **dict(zip(
    ("flow", "source", "decay"), _flow_problem(64, 96, 2))),
    scale=SCALE2, iterations=40)
_case("ledger", "ledger", C=3, W=64, Hh=96, K=8)
JP_STEP, P_STEP = _params(12)
_case("step", "erode", fields=_state_fields(_terrain(32, 48)), frozen=P_STEP,
      scale=ESCALE, steps=1)
_case("step_round", "erode", fields=_state_fields(_terrain(24, 40, 4)),
      frozen=P_STEP, scale=ESCALE, steps=1)
_, P_K = _params(20)
_case("step_k", "erode", fields=_state_fields(_terrain(64, 96)), frozen=P_K,
      scale=ESCALE, steps=1)
_, P_Q = _params(12, closure=dict(nodes=2, colors=2, color_rule="hash"))
_case("quality", "erode", fields=_state_fields(_terrain(32, 48)),
      frozen=P_Q, scale=ESCALE, steps=1)
_case("multistep", "erode", fields=_state_fields(_terrain(32, 48)),
      frozen=P_STEP, scale=ESCALE, steps=3)
_, P_TOL = _params(36, tol=1e-6)
_case("tol", "erode", fields=_state_fields(_terrain(64, 96, 5)),
      frozen=P_TOL, scale=ESCALE, steps=1)
_case("overlap", "erode", fields=_state_fields(_terrain(128, 128, 3)),
      frozen=P_K, scale=ESCALE, steps=1, single=False, overlap=True)
_, P_CASCADE = _params(4)
_case("cascade", "cascade", fields=_state_fields(_terrain(16, 16, 6)),
      levels=[((16, 16), 1), ((32, 32), 1)], world=(20.0, 20.0),
      zscale=4.0, frozen=P_CASCADE)


@pytest.fixture(scope="module")
def got():
    """Every case of the module, run once by 4 gloo CPU ranks."""
    return par.launch(ranks.run_cases, 4, transport="gloo",
                      devices=["cpu"] * 4, shape=(2, 2),
                      args=(list(CASES.values()),), timeout=240)[0]


def _bitwise(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, msg
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                  err_msg=msg)


def test_mesh_factorization_and_divisibility():
    assert par.factor2(8) == (2, 4)
    assert par.factor2(16) == (4, 4)
    assert par.factor2(7) == (1, 7)
    mesh = par.Mesh((2, 2), 3, "cpu", "gloo")
    assert mesh.coord == (1, 1)
    assert mesh.neighbor(0, -1) == 1 and mesh.neighbor(1, -1) == 2
    assert mesh.neighbor(0, +1) is None and mesh.neighbor(1, +1) is None
    par.check_divisible((32, 48), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        par.check_divisible((33, 48), mesh)
    with pytest.raises(ValueError, match="smaller than halo radius"):
        par.check_divisible((4, 4), mesh, radius=3)


def test_single_process_mesh_is_one_block_without_a_group():
    mesh = par.make_mesh(devices=["cpu"])
    assert mesh.shape == (1, 1) and not mesh.distributed
    with pytest.raises(ValueError, match="process group"):
        par.make_mesh(devices=["cpu"], transport="gloo")


def test_impossible_transports_raise():
    """No fallback: NCCL for CPU ranks or two ranks on one card, and an
    unknown transport, raise before any rank starts."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        par.launch(ranks.run_cases, 2, transport="nccl",
                   devices=["cpu", "cpu"], args=([],))
    with pytest.raises(ValueError, match="one card per rank"):
        par.mesh._check_nccl_devices(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="transport must be"):
        par.launch(ranks.run_cases, 2, transport="mpi",
                   devices=["cpu", "cpu"], args=([],))


def test_leaf_specs_and_placement():
    st = soil.ErosionState.zeros((8, 12), rainfall=1.0, uplift=0.0,
                                 albedo_surface=(1.0, 0.5, 0.25),
                                 device="cpu")
    specs = par.mesh.state_specs(st)
    assert specs.layers == (None, "X", "Y")
    assert specs.discharge == ("X", "Y") and specs.rainfall == ()
    mesh = par.Mesh((2, 2), 2, "cpu", None)
    block = par.shard_state(st, mesh)
    assert tuple(block.layers.shape) == (2, 4, 6)
    assert tuple(block.rainfall.shape) == (1, 1)
    x = np.arange(8 * 12 * 2, dtype=np.float32).reshape(8, 12, 2)
    np.testing.assert_array_equal(
        par.shard_field(x, mesh, ("X", "Y", None)).numpy(), x[4:8, 0:6])


def test_halo_pad_and_shifts_match_global(got):
    """pad then crop is the identity, and a shifted read through the halo
    equals the global shifted read, bitwise."""
    from soillib_tpu_torch.ops.stencil import _shift

    _bitwise(got["halo"]["crop"], H0)
    for dx, dy in [(-1, 0), (1, 0), (0, -1), (0, 1), (1, 1), (-1, 1)]:
        _bitwise(got["halo"][f"shift{dx},{dy}"],
                 _shift(_t(H0), dx, dy, float("nan")).numpy(),
                 f"shift {dx},{dy}")


@pytest.mark.parametrize("name", ["gradient", "negslope", "laplacian",
                                  "normal", "blur"])
def test_sharded_stencils(got, jmesh, name):
    """Bitwise the port's single-device op; rtol 1e-6 JAX's sharded op."""
    h = H2 if name == "blur" else H0
    if name == "blur":
        want = soil.gaussian_blur(_t(h), 4.0).numpy()
        jgot = jpar.ops.gaussian_blur(jnp.asarray(h), 4.0, jmesh)
    else:
        sc = SCALE3 if name == "normal" else SCALE2
        want = getattr(soil, name)(_t(h), sc).numpy()
        jgot = getattr(jpar.ops, name)(jnp.asarray(h), sc, jmesh)
    _bitwise(got["stencils"][name], want, name)
    np.testing.assert_allclose(got["stencils"][name], np.asarray(jgot),
                               rtol=1e-6, atol=1e-6)


def test_sharded_graphs(got, jmesh):
    """steepest (d8, d4), direction and random_weighted with injected
    uniforms: bitwise the port's single-device graphs and JAX's sharded
    ones; a global draw from (seed, offset) equals the single-device
    draw."""
    h, jh = _t(H0), jnp.asarray(H0)
    g = got["graphs"]
    for name, edge in (("steepest8", soil.d8), ("steepest4", soil.d4)):
        _bitwise(g[name], soil.steepest(h, edge).numpy(), name)
        _bitwise(g[name], np.asarray(jpar.ops.steepest(jh, edge,
                                                       mesh=jmesh)), name)
    _bitwise(g["direction8"], soil.direction(h, soil.d8).numpy())
    _bitwise(g["direction8"],
             np.asarray(jpar.ops.direction(jh, soil.d8, mesh=jmesh)))
    _bitwise(g["rw_injected"],
             soil.random_weighted(h, soil.d8, T=2.0, u=_t(U)).numpy())
    from soillib_tpu.ops.graph import random_weighted as jrw

    _bitwise(g["rw_injected"],
             np.asarray(jrw(jh, soil.d8, T=2.0, u=jnp.asarray(U))))
    _bitwise(g["rw_drawn"], soil.random_weighted(
        h, soil.d8, seed=5, offset=9, T=2.0).numpy())


@pytest.mark.parametrize("name", ["solve_round", "solve_k"])
def test_sharded_solve_uniform(got, jmesh, name):
    """Per round (blocks narrower than HALO_K) and K-blocked: bitwise the
    single-device solve; rtol 1e-6 JAX's sharded solve."""
    kw = CASES[name][2]
    _bitwise(got[name]["got"], got[name]["single"], name)
    jgot = jpar.ops.solve_uniform(
        jnp.asarray(kw["flow"]), jnp.asarray(kw["source"]),
        jnp.asarray(kw["decay"]), SCALE2, mesh=jmesh, iterations=40)
    np.testing.assert_allclose(got[name]["got"], np.asarray(jgot),
                               rtol=1e-6, atol=1e-6)


def test_halo_bytes_ledger(got):
    """One pad_cf of a (C, bw, bh) block at radius K posts two edge slabs
    an axis: 2*C*K*bh*4 bytes on x and 2*C*(bw+2K)*K*4 on y (the JAX
    package's per-device count); a block of the 2 x 2 mesh has one
    neighbour an axis and sends one of them."""
    C, W, Hh, K = 3, 64, 96, 8
    bw, bh = W // 2, Hh // 2
    entries = got["ledger"]["entries"]
    assert [e[0] for e in entries] == ["X", "Y"]
    assert entries[0][1:3] == (2 * C * K * bh * 4, C * K * bh * 4)
    assert entries[1][1:3] == (2 * C * (bw + 2 * K) * K * 4,
                              C * (bw + 2 * K) * K * 4)
    assert all(e[3] >= 0.0 for e in entries)  # timed=True


def _close_state(got, want, fields=STEP_FIELDS, rtol=1e-4, atol=1e-5):
    for f in fields:
        np.testing.assert_allclose(got[f], np.asarray(want[f]), rtol=rtol,
                                   atol=atol, err_msg=f)


def _jax_step(fields, jparam, jmesh, steps=1):
    jstate = jsoil.ErosionState(**{k: jnp.asarray(v)
                                   for k, v in fields.items()})
    out = jpar.sharded_erode(jstate, jmesh, ESCALE, jparam, steps=steps,
                             key=jax.random.PRNGKey(42))
    return {f.name: np.asarray(getattr(out, f.name))
            for f in dataclasses.fields(out)}


def test_sharded_step_matches_jax_and_single_device(got, jmesh):
    """One coupled step on the 2 x 2 mesh: within rtol 1e-4 / atol 1e-5 of
    JAX's sharded step, and bitwise the port's single-device step."""
    g = got["step"]
    _close_state(g["got"], _jax_step(CASES["step"][2]["fields"], JP_STEP,
                                     jmesh))
    for f in g["single"]:
        _bitwise(g["got"][f], g["single"][f], f)


@pytest.mark.parametrize("name", ["step_round", "step_k", "tol"])
def test_sharded_step_variants_match_single_device(got, name):
    """The per-round exchange (12 x 20 blocks), the K-blocked passes with
    a remainder (20 rounds) and the adaptive exit (transportTol 1e-6,
    summed over the mesh each pass; the single-device CPU path reads it
    each round) at the coupled step's bar."""
    _close_state(got[name]["got"], got[name]["single"])


def _integrals(a_all, b_all, fields=("discharge", "mass", "momentum",
                                     "debris")):
    """Totals within 1e-3 and correlation >= 0.999, field by field
    (tests/test_parallel.py's guard for trajectories that ulp-level seeds
    move past the per-cell bar)."""
    for f in fields:
        a = np.asarray(a_all[f], np.float64)
        b = np.asarray(b_all[f], np.float64)
        assert abs(a.sum() - b.sum()) <= 1e-3 * max(abs(b.sum()), 1e-12), f
        sa, sb = a - a.mean(), b - b.mean()
        denom = np.sqrt((sa * sa).sum() * (sb * sb).sum())
        if denom > 0:
            assert float((sa * sb).sum() / denom) >= 0.999, f


def test_sharded_quality_closure(got):
    """CohortClosure(nodes=2, colors=2, color_rule="hash"), whose hash
    colors use the global cell index (halo.global_offsets): the sharded
    step is the port's single-device step bitwise (tests/test_parallel.py
    :204 holds JAX's sharded step to its single-device step; the port's
    closures are held to JAX's in tests/test_torch_quality.py)."""
    g = got["quality"]
    for f in g["single"]:
        _bitwise(g["got"][f], g["single"][f], f)


def test_sharded_multistep_integrals(got):
    """Three steps: the integrals, and the layers per cell at rtol 1e-3
    (tests/test_parallel.py's multistep guard)."""
    a_all, b_all = got["multistep"]["got"], got["multistep"]["single"]
    _integrals(a_all, b_all)
    np.testing.assert_allclose(a_all["layers"], b_all["layers"], rtol=1e-3,
                               atol=1e-6)


def test_halo_overlap_schedule_equals_sequential(got):
    """SOIL_HALO_OVERLAP=1 (the interior advance while the x slabs are in
    flight, then four bands) gives the sequential schedule's step
    bitwise (64 x 64 blocks, >= 4K)."""
    g = got["overlap"]
    for f in g["got"]:
        _bitwise(g["overlap"][f], g["got"][f], f)


def test_one_block_mesh_equals_single_device_step():
    """A 1 x 1 mesh (no group: every ring is the domain boundary's fill)
    runs the single-device step bitwise, K-blocked passes and
    remainder."""
    fields = _state_fields(_terrain(32, 48, 8))
    p = params_from_frozen(P_K)
    mesh = par.make_mesh(devices=["cpu"])
    got = par.sharded_erode(state_from_numpy(fields, "cpu"), mesh, ESCALE,
                            p, steps=2)
    want = soil.erode(state_from_numpy(fields, "cpu"), ESCALE, p, steps=2)
    a, b = state_to_numpy(got), state_to_numpy(want)
    for f in a:
        _bitwise(a[f], b[f], f)


def test_sharded_step_refuses_autograd_and_particles():
    mesh = par.make_mesh(devices=["cpu"])
    h = _t(_terrain(16, 16)).requires_grad_(True)
    st = soil.ErosionState.zeros((16, 16), height=h, device="cpu")
    p = soil.ErosionParams()
    p.transportIterations = 2
    with pytest.raises(NotImplementedError, match="reverse mode"):
        par.make_sharded_erode_fn(mesh, ESCALE, p)(st)
    p.transportMethod = "particles"
    with pytest.raises(ValueError, match="transportMethod='field'"):
        par.make_sharded_erode_fn(mesh, ESCALE, p)


def test_cascade_with_a_mesh(got):
    """run_cascade(mesh=...) at [(16^2, 1), (32^2, 1)]: each level sharded,
    gathered and resized on every rank; the port's single-device cascade
    (held to JAX's in tests/test_torch_multiscale.py) at the step's
    bar."""
    kw = CASES["cascade"][2]
    want = soil.run_cascade(state_from_numpy(kw["fields"], "cpu"),
                            kw["levels"], kw["world"], kw["zscale"],
                            params_from_frozen(kw["frozen"]))
    _close_state(got["cascade"]["got"], state_to_numpy(want))
