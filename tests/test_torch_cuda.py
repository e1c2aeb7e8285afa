"""The port's CUDA kernels (soillib_tpu_torch/csrc/*.cu) against their
plain torch versions on the card. This file imports no JAX, so it runs
where the card is:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest` because tests/conftest.py configures JAX for the CPU
suite). Every test carries the `cuda` marker and skips without a CUDA
device: the kernels have no CPU mode.

Cohort kernel: `cohort_arrays` is the JAX kernel tests' seeded recipe
(tests/test_sweep.py `_cohort_problem`; soillib_tpu_torch/testing.py,
shared with chip_smoke.py) and `plain_exit_round` the adaptive-exit
probe; both are shared with tests/test_torch_cohort.py.
Tolerances are the JAX package's kernel-vs-reference bars: one round rtol
2e-6 / atol 1e-5, several rounds rtol 2e-5 / atol 1e-5 on the deposits;
bitwise where the kernel keeps the plain summation order (one-node solves
at any rounds per launch, colored solves, one N-node round). Sweep
(SWEEP_K rounds a launch) and tile kernels: bitwise against their plain
versions; whole tiled accumulations at rtol 1e-5 (phase 3's index_add
uses atomics). The particle estimators' trajectory kernel
(csrc/particle_rounds.cu) against the plain loop on the same CUDA
tensors: bitwise with one particle (its deposits land in program order),
per cell at rtol 2e-5 / atol 1e-6 of each channel's largest magnitude at
the flagship's 8192 particles (the atomics' order), bitwise under
torch.use_deterministic_algorithms; the whole particle step on the card
against the CPU at the CPU tests' bars. The host utilities have no
kernel: their cases run the plain torch code on CUDA tensors. The
compiled driver (one step
captured as a CUDA graph) is held bitwise to the eager step. The study
harnesses (soillib_tpu_torch.benchmarks) run on the card: the parity
harness's field solves bitwise against the plain rounds, the scaling
harness's shared-card step bitwise against one device.
"""

import math

import numpy as np
import pytest
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch.models import erosion
from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.ops import cohort, graph, sweep
from soillib_tpu_torch.ops import graph_tiled as gt
from soillib_tpu_torch.testing import (
    CLOSURES,
    VARIANTS,
    band_problem,
    cohort_arrays,
    split_nodes,
)

LLEN = math.sqrt(0.02)  # cell diagonal at scale (0.1, 0.1)
TOL = 1e-6
CASES = [("fluvial", True), ("fluvial", False), ("debris", True),
         ("debris", False)]


def port_rules(kind, albedo, W, H, params=None):
    """The port's real rule set of `kind` for a W x H grid."""
    p = params or ErosionParams()
    if kind == "fluvial":
        return erosion.make_fluvial_rules(p, LLEN, albedo)
    return erosion.make_debris_rules(p, LLEN, p.nSamples / (W * H), albedo)


def plain_exit_round(st, aux, rules, iters, tol=TOL):
    """First round at which the plain path's adaptive criterion fires
    (checked before every round, as `cohort_advance_reference` does), on
    the tensors' device; `iters` if it never does."""
    G = torch.zeros((st.shape[0] - cohort.NSTATE,) + tuple(st.shape[1:]),
                    device=st.device)
    for i in range(iters):
        if bool(cohort.tail_converged(
                cohort.carried_live(st), cohort.deposit_gauge(G), iters - i,
                tol, rules.contractive)):
            return i
        st, G = cohort.cohort_round(st, G, aux, rules, LLEN)
    return iters


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol, err_msg=msg)


def _on_card(st, aux):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cohort kernel has no CPU mode")
    return torch.from_numpy(st).cuda(), torch.from_numpy(aux).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,albedo", CASES)
def test_kernel_matches_plain_on_card(kind, albedo):
    """One round (state and deposits) and 16 rounds (deposits); every
    round counted, and one launch per ROUNDS_PER_LAUNCH rounds."""
    st, aux = _on_card(*cohort_arrays(kind, albedo, seed=5))
    tr = port_rules(kind, albedo, 72, 60)
    C = st.shape[0] - cohort.NSTATE
    G = torch.zeros((C,) + tuple(st.shape[1:]), device="cuda")
    n0 = cohort.cohort_round_launches[kind]
    r0 = cohort.cohort_rounds[kind]
    st_k = cohort.cohort_round_cuda(st, aux, G, tr, LLEN)
    st_p, G_p = cohort.cohort_round(st, torch.zeros_like(G), aux, tr, LLEN)
    _close(st_k, st_p, 2e-6, 1e-5, "state")
    _close(G, G_p, 2e-6, 1e-5, "deposits")
    _, g_k = cohort.cohort_advance_cuda(st, aux, tr, 16, LLEN)
    _, g_p = cohort.cohort_advance_reference(st, aux, tr, 16, LLEN)
    _close(g_k, g_p, 2e-5, 1e-5, "16-round deposits")
    assert cohort.cohort_rounds[kind] == r0 + 17
    assert cohort.cohort_round_launches[kind] == n0 + 1 + len(
        cohort.launch_rounds(16, cohort.ROUNDS_PER_LAUNCH))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["contractive", "live-zero"])
def test_kernel_adaptive_exit_on_card(mode):
    """The kernel path's `tol` exit, read every TOL_CHECK_ROUNDS rounds,
    in both modes (the problems of test_torch_cohort.py's
    `test_adaptive_exit_matches_jax`). It runs the plain path's exit round
    rounded up to the next check; its deposits match the plain adaptive
    solve within the multi-round bar plus what the extra rounds may add
    (tol times the channel's deposit gauge), and its own fixed-depth solve
    within 2e-6 (past the exit the tail is below tol, or exactly zero)."""
    iters = 88
    if mode == "contractive":
        p = ErosionParams()
        p.evapRate = 50.0
        p.depositionRateFluvial = 50.0
        st, aux = cohort_arrays("fluvial", True, 48, 40, seed=3,
                                aux3_scale=50.0)
        tr = port_rules("fluvial", True, 48, 40, p)
        assert tr.contractive
    else:
        st, aux = cohort_arrays("debris", True, 48, 40, seed=4,
                                mass_scale=1e-4)
        tr = port_rules("debris", True, 48, 40)
        assert not tr.contractive
    st, aux = _on_card(st, aux)
    exit_plain = plain_exit_round(st, aux, tr, iters)
    assert 0 < exit_plain < iters // 2, f"exit at {exit_plain}/{iters}"
    every = cohort.TOL_CHECK_ROUNDS
    n0 = cohort.cohort_rounds[tr.kind]
    _, g_k = cohort.cohort_advance_cuda(st, aux, tr, iters, LLEN, tol=TOL)
    rounds = cohort.cohort_rounds[tr.kind] - n0
    assert rounds == min(iters, -(-exit_plain // every) * every), (
        rounds, exit_plain)

    _, g_p = cohort.cohort_advance_reference(st, aux, tr, iters, LLEN,
                                             tol=TOL)
    tail = TOL * cohort.deposit_gauge(g_p)[:, None, None]
    err = (g_k - g_p).abs()
    assert bool((err <= 1e-5 + tail + 2e-5 * g_p.abs()).all()), (
        f"adaptive deposits vs plain: max abs err {float(err.max()):.3e}")
    _, g_fix = cohort.cohort_advance_cuda(st, aux, tr, iters, LLEN)
    _close(g_k, g_fix, 2e-6, 1e-6, "adaptive vs fixed depth")


def _equal(got, want, msg):
    assert torch.equal(got, want), (
        f"{msg}: not bitwise equal, max abs err "
        f"{float((got - want).abs().max()):.3e}")


def _by_launches(st, aux, tr, rounds, k):
    """`rounds` rounds through `cohort_rounds_cuda`, split as the wrapper
    splits them with k rounds a launch; returns (state, deposits)."""
    G = torch.zeros((st.shape[0] - cohort.NSTATE,) + tuple(st.shape[1:]),
                    device=st.device)
    for n in cohort.launch_rounds(rounds, k):
        st = cohort.cohort_rounds_cuda(st, aux, G, tr, LLEN, n)
    return st, G


@pytest.mark.cuda
@pytest.mark.parametrize("kind,albedo", CASES)
@pytest.mark.parametrize("W,H", [(200, 72), (4097, 33)])
@pytest.mark.parametrize("k", [1, 2])
def test_rounds_kernel_bitwise_on_card(kind, albedo, W, H, k):
    """The one-node kernel at k rounds a launch (every k the wrapper
    chooses: 1 for colored solves, ROUNDS_PER_LAUNCH otherwise) for 1,
    k - 1, k and 3k + 2 rounds, on grids that are not a multiple of the
    tile: state and deposits bitwise equal to the plain rounds; every
    round and launch counted."""
    assert k in (1, cohort.ROUNDS_PER_LAUNCH)
    st, aux = _on_card(*cohort_arrays(kind, albedo, W, H, seed=W + H))
    tr = port_rules(kind, albedo, W, H)
    for rounds in sorted({1, max(k - 1, 1), k, 3 * k + 2}):
        n0 = cohort.cohort_round_launches[kind]
        r0 = cohort.cohort_rounds[kind]
        st_k, g_k = _by_launches(st, aux, tr, rounds, k)
        assert cohort.cohort_rounds[kind] == r0 + rounds
        assert cohort.cohort_round_launches[kind] == n0 + -(-rounds // k)
        st_p, g_p = cohort.cohort_advance_reference(st, aux, tr, rounds,
                                                    LLEN)
        _equal(st_k, st_p, f"{rounds} rounds, state")
        _equal(g_k, g_p, f"{rounds} rounds, deposits")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,albedo", [("fluvial", True),
                                         ("debris", False)])
def test_colored_one_node_solve_bitwise_on_card(kind, albedo):
    """A one-node solve with three colors runs one round per launch and
    color group, in color order, into the same deposits: the plain
    batched round's order, so state and deposits are bitwise equal."""
    W, H, iters, M = 90, 70, 11, 3
    sts = [cohort_arrays(kind, albedo, W, H, seed=20 + j) for j in range(M)]
    st, aux = _on_card(np.concatenate([s for s, _ in sts]), sts[0][1])
    tr = port_rules(kind, albedo, W, H)
    cl = soil.CohortClosure(colors=M)
    n0 = cohort.cohort_round_launches[kind]
    r0 = cohort.cohort_rounds[kind]
    st_k, g_k = cohort.cohort_advance_cuda(st, aux, tr, iters, LLEN,
                                           closure=cl)
    assert cohort.cohort_round_launches[kind] == n0 + M * iters
    assert cohort.cohort_rounds[kind] == r0 + M * iters
    st_p, g_p = cohort.cohort_advance_reference(st, aux, tr, iters, LLEN,
                                                closure=cl)
    _equal(st_k, st_p, "colored state")
    _equal(g_k, g_p, "colored deposits")


@pytest.mark.cuda
def test_adaptive_exit_with_a_short_last_launch_on_card():
    """35 rounds with the `tol` exit on a problem that does not exit
    early: checks at rounds 0, 16 and 32 fall on launch boundaries, the
    last launch runs one round, and the deposits are bitwise those of the
    plain fixed-depth solve."""
    iters = 35
    st, aux = _on_card(*cohort_arrays("fluvial", True, 72, 60, seed=6))
    tr = port_rules("fluvial", True, 72, 60)
    assert plain_exit_round(st, aux, tr, iters) == iters
    split = cohort.launch_rounds(iters, cohort.ROUNDS_PER_LAUNCH)
    assert split[-1] == 1 and sum(split[:8]) == 16
    n0 = cohort.cohort_round_launches["fluvial"]
    r0 = cohort.cohort_rounds["fluvial"]
    _, g_k = cohort.cohort_advance_cuda(st, aux, tr, iters, LLEN, tol=TOL)
    assert cohort.cohort_rounds["fluvial"] == r0 + iters
    assert cohort.cohort_round_launches["fluvial"] == n0 + len(split)
    _, g_p = cohort.cohort_advance_reference(st, aux, tr, iters, LLEN)
    _equal(g_k, g_p, "deposits")


# ---------------------------------------------------------------------------
# The transport sweep (csrc/transport_sweep.cu) and the tile kernels of the
# tiled accumulation (csrc/tile_accumulate.cu): bitwise against their plain
# versions (the kernels are built with -fmad=false and repeat the plain
# arithmetic in its order; a tile converges exactly).
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def sweep_arrays(C, W, H, seed=0):
    """Seeded sweep inputs (E, att, vx, vy) on the card; a few dead cells
    (zero direction) included."""
    rng = np.random.default_rng(seed)
    E = np.abs(rng.normal(size=(C, W, H)))
    att = rng.uniform(0.3, 0.99, size=(C, W, H))
    d = rng.normal(size=(2, W, H))
    d[:, ::9, ::7] = 0.0
    n = np.maximum(np.sqrt(d[0] ** 2 + d[1] ** 2), 1e-30)
    return [torch.from_numpy(a.astype(np.float32)).cuda()
            for a in (E, att, d[0] / n, d[1] / n)]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 7, 13])
@pytest.mark.parametrize("iters", [1, 16])
def test_sweep_kernel_matches_plain_on_card(C, iters):
    """1 and 16 rounds, C up to 13 (past the JAX kernel's cap), a grid of
    several ragged blocks; one launch counted per SWEEP_K rounds and one
    for the remainder, and every round counted."""
    _needs_card()
    E, att, vx, vy = sweep_arrays(C, 75, 61, seed=C)
    G0 = torch.rand((C, 75, 61), device="cuda")
    n0 = sweep.sweep_launches["round"]
    r0 = sweep.sweep_rounds["round"]
    got = sweep.transport_advance(G0, E, att, vx, vy, iters)
    assert (sweep.sweep_launches["round"] - n0
            == len(sweep.sweep_launch_rounds(iters))
            == -(-iters // sweep.SWEEP_K))
    assert sweep.sweep_rounds["round"] - r0 == iters
    want = sweep.transport_advance_reference(G0, E, att, vx, vy, iters)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


SWEEP_ROUNDS = [1, sweep.SWEEP_K - 1, sweep.SWEEP_K, sweep.SWEEP_K + 1,
                2 * sweep.SWEEP_K + 3, 37]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 7, 13])
@pytest.mark.parametrize("W,H", [(75, 61), (5, 3), (sweep.SWEEP_K - 3, 200),
                                 (70, 250), (70, 244)])
def test_sweep_blocked_kernel_bitwise_on_card(C, W, H):
    """The K-round kernel bitwise against the plain rounds at every rounds
    count of SWEEP_ROUNDS (one launch, a remainder, several launches), on
    ragged domains: several tiles each way, one smaller than a tile, one
    narrower than the ring; H a multiple of 4 (the windows staged through
    tensor maps) and not (each thread's own copies); a non-zero G0,
    zero-direction cells and both signs of vx and vy."""
    _needs_card()
    E, att, vx, vy = sweep_arrays(C, W, H, seed=C + W)
    assert bool((vx > 0).any() and (vx < 0).any() and (vy > 0).any()
                and (vy < 0).any() and ((vx == 0) & (vy == 0)).any())
    G0 = torch.rand((C, W, H), device="cuda") * 2.0
    for iters in SWEEP_ROUNDS:
        got = sweep.transport_advance(G0, E, att, vx, vy, iters)
        want = sweep.transport_advance_reference(G0, E, att, vx, vy, iters)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                      err_msg=f"{iters} rounds")


@pytest.mark.cuda
def test_sweep_kernel_refuses_another_geometry_on_card():
    """The C entry refuses a geometry other than its own, and the wrapper
    raises on the error it returns."""
    _needs_card()
    E, att, vx, vy = sweep_arrays(1, 40, 40)
    G0 = torch.zeros_like(E)
    out = torch.empty_like(E)
    geo = sweep.sweep_geometry(
        1, 40, 40, 2,
        torch.cuda.get_device_properties(E.device).multi_processor_count)
    fn = sweep._sweep_fn()
    stream = torch.cuda.current_stream().cuda_stream
    args = [G0.data_ptr(), E.data_ptr(), att.data_ptr(), vx.data_ptr(),
            vy.data_ptr(), out.data_ptr(), 1, 40, 40]
    good = [geo.rounds, *geo.block, *geo.grid, geo.ring, geo.smem]
    assert fn(*args, *good, stream) == 0
    for j, bad in ((0, sweep.SWEEP_K + 1), (1, 128), (3, geo.grid[0] + 1),
                   (4, 2), (5, geo.ring - 1), (6, geo.smem + 4)):
        wrong = list(good)
        wrong[j] = bad
        assert fn(*args, *wrong, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sweep_autograd_on_card():
    """run_transport on the card goes through the autograd Function: the
    gradient (kernel forward, checkpointed plain backward) equals the plain
    rounds' own autograd gradient."""
    _needs_card()
    E, att, vx, vy = sweep_arrays(3, 24, 24, seed=6)
    ins = [t.clone().requires_grad_(True) for t in (E, att, vx, vy)]
    out = sweep.run_transport(*ins, 37)
    (out * out).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (E, att, vx, vy)]
    want = sweep.transport_sweep_reference(*ref, 37)
    (want * want).sum().backward()
    np.testing.assert_array_equal(out.detach().cpu().numpy(),
                                  want.detach().cpu().numpy())
    for a, b in zip(ins, ref):
        _close(a.grad, b.grad, 1e-5, 1e-5, "gradient")


def terrain_slots(W, H, d8, seed=0):
    """Slot graph of a seeded rough terrain's steepest descent (numpy
    ridges + noise), by the port's own ops on the card."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 6, W)[:, None]
    y = np.linspace(0, 5, H)[None, :]
    h = np.sin(x) * np.cos(y) + 0.3 * rng.normal(size=(W, H))
    h = torch.from_numpy(h.astype(np.float32)).cuda()
    edge = 1 if d8 else 0
    return graph.graph_to_slots(graph.steepest(h, edge), edge)


def serpentine_slots(W, H):
    """A D4 slot graph whose first 128^2 tile is one serpentine path of
    128^2 cells (the worst case in-tile path), leaving the tile at its
    last cell; every other cell flows +x, and the last row is roots."""
    T = 128
    s = np.full((W, H), 3, np.int32)          # +x
    s[-1, :] = -1
    for x in range(min(T, W)):
        if x % 2 == 0:
            s[x, :T - 1] = 2                   # +y
        else:
            s[x, 1:T] = 1                      # -y
        s[x, T - 1 if x % 2 == 0 else 0] = 3   # down to the next row
    return torch.from_numpy(s).cuda()


SLOT_CASES = [("terrain-d4", 300, 260), ("terrain-d8", 300, 260),
              ("terrain-d8", 100, 90), ("serpentine", 200, 140)]


def _slots(case, W, H):
    if case == "serpentine":
        return serpentine_slots(W, H), 0
    d8 = case.endswith("d8")
    return terrain_slots(W, H, d8, seed=W), int(d8)


@pytest.mark.cuda
@pytest.mark.parametrize("case,W,H", SLOT_CASES)
def test_tile_kernels_match_plain_on_card(case, W, H):
    """Phases 1/4 (local push) and 2 (trace), bitwise against the plain
    full-grid fixed points on the same inputs, on ragged grids and on a
    serpentine path through a whole tile."""
    _needs_card()
    slot, edge = _slots(case, W, H)
    lslot, cross = gt._local_slot(W, H, slot, edge)
    n = torch.arange(W * H, dtype=torch.int32, device="cuda").reshape(W, H)
    recv = gt._pull(n, slot, edge, 0)
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.uniform(0.5, 2.0, (W, H)).astype(
        np.float32)).cuda()
    w = torch.from_numpy(rng.uniform(0.8, 1.0, (W, H)).astype(
        np.float32)).cuda()
    if case == "serpentine":
        # Unit weights: with w < 1 the far upstream terms fall below an
        # ulp and the tile settles bitwise long before the path's end.
        w = torch.ones_like(w)
    iters = gt.TILE ** 2
    n0 = dict(gt.tile_launches)
    G, rounds = gt.local_fp_cuda(lslot.contiguous(), src, w, edge, iters)
    X, D, trounds = gt.trace_cuda(slot.contiguous(), w, edge, iters)
    assert gt.tile_launches == {"local": n0["local"] + 1,
                                "trace": n0["trace"] + 1}
    G_p = gt.local_fp_plain(lslot, src, w, edge, iters)
    X_p, D_p = gt.trace_plain(slot, cross, recv, w, edge, iters)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(G.cpu().numpy(), G_p.cpu().numpy())
    np.testing.assert_array_equal(X.cpu().numpy(), X_p.cpu().numpy())
    np.testing.assert_array_equal(D.cpu().numpy(), D_p.cpu().numpy())
    # Every tile finishes under the dependency schedule: `rounds` holds
    # each tile's depth (>= 0), not Jacobi rounds (< 0).
    assert int(rounds.min()) >= 0 and int(trounds.min()) >= 0
    if case == "serpentine":
        # 128^2 - 1 edges on the path: the first tile's depth in both
        # kernels.
        assert int(rounds[0]) == iters - 1 and int(trounds[0]) == iters - 1


def _tile_pair(slot, edge, src, w, iters):
    """(kernel, plain) results of phases 1/4 and 2 on the card, and the
    kernels' per-tile rounds."""
    W, H = slot.shape
    lslot, cross = gt._local_slot(W, H, slot, edge)
    n = torch.arange(W * H, dtype=torch.int32, device="cuda").reshape(W, H)
    recv = gt._pull(n, slot, edge, 0)
    G, rounds = gt.local_fp_cuda(lslot.contiguous(), src, w, edge, iters)
    X, D, trounds = gt.trace_cuda(slot.contiguous(), w, edge, iters)
    G_p = gt.local_fp_plain(lslot, src, w, edge, iters)
    X_p, D_p = gt.trace_plain(slot, cross, recv, w, edge, iters)
    torch.cuda.synchronize()
    for got, want, what in ((G, G_p, "G"), (X, X_p, "X"), (D, D_p, "D")):
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                      err_msg=what)
    return rounds.cpu(), trounds.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("d8", [0, 1])
def test_tile_kernels_with_a_cycle_on_card(d8):
    """A two-cell cycle in the first tile: that tile never finishes under
    the schedule and runs the Jacobi branch under the cap (256 rounds),
    bitwise equal to the plain fixed points; the other tiles keep the
    schedule."""
    _needs_card()
    W, H = 300, 260
    slot = terrain_slots(W, H, d8, seed=7)
    shifts = [tuple(int(v) for v in sh) for sh in
              graph.shifts_for(d8)]
    slot[40, 40] = shifts.index((1, 0))
    slot[41, 40] = shifts.index((-1, 0))
    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.uniform(0.5, 2.0, (W, H)).astype(
        np.float32)).cuda()
    w = torch.from_numpy(rng.uniform(0.8, 1.0, (W, H)).astype(
        np.float32)).cuda()
    rounds, trounds = _tile_pair(slot, d8, src, w, 256)
    assert int(rounds[0]) < 0 and int(trounds[0]) < 0
    assert int(rounds[1:].min()) >= 0 and int(trounds[1:].min()) >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [32, 4096, 16383])
def test_tile_kernels_with_a_binding_cap_on_card(iters):
    """The serpentine (depth 128^2 - 1 in its first tile) under a cap of
    `_tile_cap(iters)` rounds: below the depth the first tile runs that
    many Jacobi rounds and returns the plain version's truncated sums;
    at 16383 the cap (16384) covers the depth. The other tiles' +x
    chains (up to 127 edges) keep the schedule where the cap covers them.
    Bitwise either way."""
    _needs_card()
    W, H = 200, 140
    slot = serpentine_slots(W, H)
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.uniform(0.5, 2.0, (W, H)).astype(
        np.float32)).cuda()
    w = torch.ones_like(src)
    rounds, trounds = _tile_pair(slot, 0, src, w, iters)
    cap = gt._tile_cap(iters)
    want = gt.TILE ** 2 - 1 if cap >= gt.TILE ** 2 - 1 else -cap
    assert int(rounds[0]) == want and int(trounds[0]) == want
    if cap >= gt.TILE - 1:
        assert int(rounds[1:].min()) >= 0 and int(trounds[1:].min()) >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("case,W,H", SLOT_CASES)
def test_accumulate_on_card_matches_plain_and_doubling(case, W, H):
    """The whole tiled accumulation through the kernels (the default for
    CUDA tensors) against the plain tiled solver and pointer doubling, at
    rtol 1e-5 (phase 3's index_add uses atomics)."""
    _needs_card()
    slot, edge = _slots(case, W, H)
    n = torch.arange(W * H, dtype=torch.int32, device="cuda").reshape(W, H)
    g = torch.where(slot < 0, -1, gt._pull(n, slot, edge, 0))
    rain = torch.ones((W, H), device="cuda")
    for decay in (None, 0.9):
        w = graph._edge_weights(g, decay, edge)
        got = gt.accumulate_tiled(slot, rain, w, edge)
        plain = gt.accumulate_tiled(slot, rain, w, edge, tile_solver="plain")
        dbl = graph._accumulate_doubling(g, rain, w)
        _close(got, plain, 1e-5, 1e-5, f"plain tiled, decay {decay}")
        _close(got, dbl, 1e-5, 1e-5, f"doubling, decay {decay}")
    # The public entry picks the kernels for a CUDA graph.
    n0 = gt.tile_launches["local"]
    area = soil.accumulate(g, 1.0, edge)
    assert gt.tile_launches["local"] > n0
    roots = g < 0
    assert abs(float(area[roots].double().sum()) - W * H) <= 1e-4 * W * H


# ---------------------------------------------------------------------------
# Gradients through the kernels: the autograd Functions (kernel forward,
# plain backward) against the plain paths' own autograd gradients.
# ---------------------------------------------------------------------------


def _cohort_grads(solve, st, aux):
    s = st.clone().requires_grad_(True)
    a = aux.clone().requires_grad_(True)
    G = solve(s, a)
    assert G.requires_grad
    return G.detach(), torch.autograd.grad((G * G).sum(), (s, a))


@pytest.mark.cuda
@pytest.mark.parametrize("nodes", [1, 4])
def test_cohort_autograd_on_card(nodes):
    """run_cohort on the card carries a graph (DiffableCohort): one node
    with the `tol` exit (the kernel path stops at its 16-round check, and
    the backward replays the rounds it ran) and NODES=4; the gradients for
    the state and aux equal the plain rounds' own autograd gradient at
    rtol 1e-5 / atol 1e-5."""
    if nodes == 1:
        p = ErosionParams()
        p.evapRate = 50.0
        p.depositionRateFluvial = 50.0
        st, aux = _on_card(*cohort_arrays("fluvial", True, 48, 40, seed=3,
                                          aux3_scale=50.0))
        tr = port_rules("fluvial", True, 48, 40, p)
        cl, iters, tol = None, 88, TOL
    else:
        st, aux = _on_card(*node_state("fluvial", True, 4, 40, 36))
        tr = port_rules("fluvial", True, 40, 36)
        cl, iters, tol = soil.CohortClosure(nodes=4), 5, 0.0
    key = cohort.launch_key("fluvial", nodes)
    r0 = cohort.cohort_rounds[key]
    G, got = _cohort_grads(lambda s, a: cohort.run_cohort(
        s, a, tr, iters, LLEN, cl, tol=tol), st, aux)
    ran = cohort.cohort_rounds[key] - r0
    if nodes == 1:
        assert 0 < ran < iters and ran % cohort.TOL_CHECK_ROUNDS == 0
    else:
        assert ran == iters
    G_p, want = _cohort_grads(lambda s, a: cohort.cohort_advance_reference(
        s, a, tr, ran, LLEN, closure=cl)[1], st, aux)
    _close(G, G_p, 2e-5, 1e-5, "deposits")
    for g, w, what in zip(got, want, ("state", "aux")):
        _close(g, w, 1e-5, 1e-5, f"{what} gradient")


@pytest.mark.cuda
@pytest.mark.parametrize("case,W,H", [("terrain-d8", 300, 260),
                                      ("terrain-d4", 100, 90)])
def test_accumulate_autograd_on_card(case, W, H):
    """accumulate and accumulate_decay through the tile kernels carry a
    graph (DiffableTiledAccumulate): the gradients w.r.t. the value and a
    per-cell decay tensor equal pointer doubling's own autograd gradient
    at rtol 1e-5 with an absolute floor of 1e-5 of the gradient's scale
    (both run index_add with atomics on the card), and the plain tiled
    solver's."""
    _needs_card()
    slot, edge = _slots(case, W, H)
    g = torch.where(slot < 0, -1, gt._pull(torch.arange(
        W * H, dtype=torch.int32, device="cuda").reshape(W, H), slot, edge,
        0))
    rng = np.random.default_rng(W)
    v0 = torch.from_numpy(rng.uniform(0.5, 2.0, (W, H)).astype(
        np.float32)).cuda()
    d0 = torch.from_numpy(rng.uniform(0.8, 1.0, (W, H)).astype(
        np.float32)).cuda()
    ct = torch.from_numpy(rng.normal(size=(W, H)).astype(np.float32)).cuda()

    def grads(method):
        v = v0.clone().requires_grad_(True)
        d = d0.clone().requires_grad_(True)
        a = soil.accumulate(g, v, edge, method=method)
        b = soil.accumulate_decay(g, v, d, edge, method=method)
        assert a.requires_grad and b.requires_grad
        return torch.autograd.grad((a * ct).sum() + (b * ct).sum(), (v, d))

    def plain_tiled():
        v = v0.clone().requires_grad_(True)
        d = d0.clone().requires_grad_(True)
        w = graph._edge_weights(g, d, edge)
        a = gt.accumulate_tiled(slot, v, None, edge, tile_solver="plain")
        b = gt.accumulate_tiled(slot, v, w, edge, tile_solver="plain")
        return torch.autograd.grad((a * ct).sum() + (b * ct).sum(), (v, d))

    n0 = gt.tile_launches["local"]
    got = grads(None)
    assert gt.tile_launches["local"] > n0
    for what, want in (("doubling", grads("doubling")),
                       ("plain tiled", plain_tiled())):
        for x, y, name in zip(got, want, ("value", "decay")):
            _close(x, y, 1e-5, 1e-5 * float(y.abs().max()),
                   f"{name} gradient vs {what}")


# ---------------------------------------------------------------------------
# The quality closures through the cohort kernel (NODES = 2 and 4; colors
# as one launch per color group) and the FP32 probe (csrc/fp32_chain.cu).
# ---------------------------------------------------------------------------


def node_state(kind, albedo, nodes, W, H, seed=0):
    """A node-stacked cohort state, one seeded ensemble per node, and the
    first ensemble's aux."""
    sts = [cohort_arrays(kind, albedo, W, H, seed + 10 * j)
           for j in range(nodes)]
    return np.concatenate([s for s, _ in sts]), sts[0][1]


def closure_state(kind, albedo, closure, W, H, seed=0, mass_scale=1.0):
    """A seeded cohort state for `closure` and its aux (float32 numpy): one
    ensemble (`cohort_arrays`) split over the nodes (`split_nodes`)."""
    st, aux = cohort_arrays(kind, albedo, W, H, seed, mass_scale)
    return split_nodes(torch.from_numpy(st), closure).numpy(), aux


@pytest.mark.cuda
@pytest.mark.parametrize("kind,albedo", CASES)
@pytest.mark.parametrize("nodes", [2, 4])
@pytest.mark.parametrize("W,H", [(64, 64), (200, 72), (130, 33)])
def test_nodes_kernel_matches_plain_on_card(kind, albedo, nodes, W, H):
    """The face-routed N-node round: one round (state and deposits) and
    16 rounds (deposits) against the plain nodes round, on a square grid
    and on ones that are not a multiple of the tile or the cluster; one
    launch per round, and one round bitwise equal to the plain one."""
    st, aux = _on_card(*node_state(kind, albedo, nodes, W, H, seed=7))
    tr = port_rules(kind, albedo, W, H)
    cl = soil.CohortClosure(nodes=nodes)
    C = cohort.n_deposits(st.shape[0], cl)
    G = torch.zeros((C,) + tuple(st.shape[1:]), device="cuda")
    key = cohort.launch_key(kind, nodes)
    n0 = cohort.cohort_round_launches[key]
    st_k = cohort.cohort_round_cuda(st, aux, G, tr, LLEN, nodes=nodes)
    st_p, G_p = cohort.cohort_round(st, torch.zeros_like(G), aux, tr, LLEN,
                                    cl)
    _close(st_k, st_p, 2e-6, 1e-5, "state")
    _close(G, G_p, 2e-6, 1e-5, "deposits")
    _, g_k = cohort.cohort_advance_cuda(st, aux, tr, 16, LLEN, closure=cl)
    _, g_p = cohort.cohort_advance_reference(st, aux, tr, 16, LLEN,
                                             closure=cl)
    _close(g_k, g_p, 2e-5, 1e-5, "16-round deposits")
    assert cohort.cohort_round_launches[key] == n0 + 17
    assert torch.equal(st_k, st_p) and torch.equal(G, G_p), (
        "one round is not bitwise equal to the plain nodes round")


@pytest.mark.cuda
def test_colored_chunks_on_card_match_batched_plain(monkeypatch):
    """A colored solve (nodes=4, colors=4, hash rule) through the kernel
    in two chunks of two color groups against the plain rounds with all
    four colors batched into one solve, both on the card; the kernel
    launches once per color group and round."""
    from soillib_tpu_torch.core.halo import NO_HALO

    _needs_card()
    W, H, iters = 48, 40, 12
    st0, aux = cohort_arrays("fluvial", True, W, H, seed=9)
    speed = np.random.default_rng(9).normal(size=(2, W, H)).astype(
        np.float32)
    w0, carried = (torch.from_numpy(st0[0]).cuda(),
                   [torch.from_numpy(c).cuda() for c in st0[cohort.NSTATE:]])
    sp, ax = torch.from_numpy(speed).cuda(), torch.from_numpy(aux).cuda()
    tr = port_rules("fluvial", True, W, H)
    cl = soil.CohortClosure(nodes=4, colors=4, color_rule="hash")
    chunks = []

    def two(M, *args):
        chunks.append(M // 2)
        return M // 2

    monkeypatch.setattr(erosion, "color_chunk", two)
    n0 = cohort.cohort_round_launches["fluvial,nodes=4"]
    got = erosion._run_cohort_colored(NO_HALO, w0, sp, carried, ax, tr,
                                      iters, LLEN, cl)
    assert chunks == [2]
    assert cohort.cohort_round_launches["fluvial,nodes=4"] == n0 + 4 * iters

    def plain(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        return cohort.cohort_advance_reference(
            cohort.as_stack(st0), cohort.as_stack(aux), rules, int(iters),
            Llen, closure=closure, tol=tol)[1]

    monkeypatch.setattr(erosion, "color_chunk", lambda M, *args: M)
    monkeypatch.setattr(cohort, "run_cohort", plain)
    want = erosion._run_cohort_colored(NO_HALO, w0, sp, carried, ax, tr,
                                       iters, LLEN, cl)
    _close(got, want, 2e-5, 1e-5, "colored deposits")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["fma", "fma2", "exp", "div", "sqrt"])
def test_probe_kernel_matches_plain_on_card(op):
    """Each op of the FP32 probe against its plain chains at 4 rounds
    (rtol 1e-5: the plain fma rounds twice, through float64); one launch
    counted per call."""
    from soillib_tpu_torch.ops import fp32_chain

    _needs_card()
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0.25, 1.0, 4096 + 37).astype(np.float32)).cuda()
    n0 = fp32_chain.fp32_chain_launches[op]
    got = fp32_chain.chain_cuda(x, op, 4)
    assert fp32_chain.fp32_chain_launches[op] == n0 + 1
    want = fp32_chain.chain_plain(x, op, 4)
    _close(got, want, 1e-5, 0.0, op)


# ---------------------------------------------------------------------------
# Sizes that are not multiples of the tiles and blocks, and the multiscale
# cascade's modules on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fluvial", "debris"])
def test_cohort_kernel_bitwise_at_1000_on_card(kind):
    """The cascade's finest level, 1000^2: partial owned tiles on both
    axes. 16 rounds at the wrapper's split, state and deposits bitwise
    equal to the plain rounds."""
    st, aux = _on_card(*cohort_arrays(kind, True, 1000, 1000, seed=11))
    tr = port_rules(kind, True, 1000, 1000)
    st_k, g_k = cohort.cohort_advance_cuda(st, aux, tr, 16, LLEN)
    st_p, g_p = cohort.cohort_advance_reference(st, aux, tr, 16, LLEN)
    _equal(st_k, st_p, "state")
    _equal(g_k, g_p, "deposits")


@pytest.mark.cuda
@pytest.mark.parametrize("W,H", [(1000, 1000), (1000, 744)])
@pytest.mark.parametrize("d8", [0, 1])
def test_tile_kernels_bitwise_at_ragged_sizes_on_card(W, H, d8):
    """7 full tiles and one of 104 cells along x (and y at 1000^2; 5 and
    104 at 744): the push and trace bitwise equal to the plain fixed
    points, and the whole decayed accumulation equal to pointer doubling
    at the tiled bar."""
    _needs_card()
    rng = np.random.default_rng(W + H + d8)
    x = np.linspace(0, 6, W)[:, None]
    y = np.linspace(0, 5, H)[None, :]
    h = np.sin(x) * np.cos(y) + 0.3 * rng.normal(size=(W, H))
    flow = graph.steepest(torch.from_numpy(h.astype(np.float32)).cuda(), d8)
    src = torch.from_numpy(rng.uniform(0.5, 2.0, (W, H)).astype(
        np.float32)).cuda()
    w = torch.from_numpy(rng.uniform(0.8, 1.0, (W, H)).astype(
        np.float32)).cuda()
    _tile_pair(graph.graph_to_slots(flow, d8), d8, src, w, gt.TILE ** 2)
    n0 = dict(gt.tile_launches)
    got = soil.accumulate_decay(flow, src, w, d8)
    assert gt.tile_launches == {"local": n0["local"] + 2,
                                "trace": n0["trace"] + 1}
    _close(got, soil.accumulate_decay(flow, src, w, d8, method="doubling"),
           1e-5, 1e-5, "accumulate_decay vs doubling")


@pytest.mark.cuda
def test_boundary_set_is_built_once_per_shape_and_device_on_card():
    _needs_card()
    a = gt._boundary_index_tensor(1000, 744, torch.device("cuda", 0))
    b = gt._boundary_index_tensor(1000, 744, torch.device("cuda", 0))
    assert a is b and a.device.type == "cuda"
    np.testing.assert_array_equal(a.cpu().numpy(),
                                  gt._boundary_indices(1000, 744))


@pytest.mark.cuda
def test_resize_state_and_blur_on_card_equal_the_cpu():
    _needs_card()
    rng = np.random.default_rng(4)
    h = rng.random((50, 38)).astype(np.float32)
    st = soil.ErosionState.zeros((50, 38), height=h, device="cpu")
    st = st.replace(momentum=torch.from_numpy(
        rng.normal(size=(2, 50, 38)).astype(np.float32)))
    for res in ((1000, 744), (17, 9)):
        cpu = soil.resize_state(st, res)
        card = soil.resize_state(
            soil.ErosionState(**{k: v.cuda() for k, v in
                                 vars(st).items()}), res)
        for k, v in vars(cpu).items():
            _close(getattr(card, k), v, 1e-6, 0.0, f"resize_state {k}")
    for shape in ((300, 200), (64, 80, 3)):
        a = rng.random(shape).astype(np.float32)
        for sigma in (0.5, 12.0):
            _close(soil.gaussian_blur(torch.from_numpy(a).cuda(), sigma),
                   soil.gaussian_blur(a, sigma, device="cpu"), 1e-6, 0.0,
                   f"blur {shape} sigma {sigma}")


@pytest.mark.cuda
def test_cascade_on_card_launches_the_cohort_kernel():
    """16^2 for 2 steps, then 32^2 for 1 step, 4 transport rounds: the
    cohort kernel launches at both levels, and the final state equals the
    CPU cascade's at the multi-round cohort bar (rtol 2e-5, atol 1e-5 of
    each field's scale)."""
    _needs_card()
    p = ErosionParams()
    p.transportIterations = 4
    h = soil.noise((16, 16), soil.noise_t(ext=(64.0, 64.0)),
                   device="cpu") * 0.5 + 2.0
    kw = dict(levels=[((16, 16), 2), ((32, 32), 1)],
              world_extent=(20.0, 20.0), zscale=4.0, param=p)
    before = dict(cohort.cohort_round_launches)
    seen = []
    card = soil.run_cascade(soil.ErosionState.zeros((16, 16), height=h),
                            on_level=lambda i, res, s: seen.append(
                                dict(cohort.cohort_round_launches)), **kw)
    cpu = soil.run_cascade(
        soil.ErosionState.zeros((16, 16), height=h, device="cpu"), **kw)
    # Two solves a step, 4 rounds each at ROUNDS_PER_LAUNCH a launch.
    per = 2 * len(cohort.launch_rounds(4, cohort.ROUNDS_PER_LAUNCH))
    launched = [sum(s.values()) - sum(before.values()) for s in seen]
    assert launched == [2 * per, 3 * per]
    assert card.layers.device.type == "cuda"
    for k, v in vars(cpu).items():
        want = v.numpy()
        _close(getattr(card, k), v, 2e-5,
               1e-5 * float(np.abs(want).max()), f"cascade {k}")


# ---------------------------------------------------------------------------
# The closure variants of the cohort kernel: each closure runs the library
# built for it (ops/cohort.py `KernelVariant`).
# ---------------------------------------------------------------------------

def variant_problem(kind, name, W, H, seed):
    """A closure variant's seeded state and aux on the card and its rule
    set; debris with physical debris masses (1e-3 of the seeded carried
    mass: at O(1) masses the non-contractive debris rules grow the carried
    mass to the 1e30 clip within a few rounds)."""
    st, aux = _on_card(*closure_state(kind, True, CLOSURES[name], W, H, seed,
                                      1.0 if kind == "fluvial" else 1e-3))
    return st, aux, port_rules(kind, True, W, H)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fluvial", "debris"])
@pytest.mark.parametrize("name", VARIANTS)
def test_closure_variant_kernel_matches_plain_on_card(name, kind):
    """Each closure variant's kernel against the plain round on the card at
    1000 x 744 (not a multiple of the tiles or clusters): one round, state
    and deposits bitwise; 16 rounds through the wrapper's split, bitwise
    for one node (ROUNDS_PER_LAUNCH rounds a launch) and at rtol 2e-5 /
    atol 1e-5 on the deposits for N nodes; every launch counted under the
    variant's key."""
    cl = CLOSURES[name]
    W, H = 1000, 744
    st, aux, tr = variant_problem(kind, name, W, H, seed=13)
    nodes = cl.nodes
    C = cohort.n_deposits(st.shape[0], cl)
    G = torch.zeros((C, W, H), device="cuda")
    key = cohort.launch_key(kind, nodes,
                            cohort.kernel_variant(cl, nodes).tag)
    n0 = cohort.cohort_round_launches.get(key, 0)
    st_k = cohort.cohort_round_cuda(st, aux, G, tr, LLEN, nodes=nodes,
                                    closure=cl)
    st_p, G_p = cohort.cohort_round(st, torch.zeros_like(G), aux, tr, LLEN,
                                    cl)
    _equal(st_k, st_p, "1-round state")
    _equal(G, G_p, "1-round deposits")
    st_k, g_k = cohort.cohort_advance_cuda(st, aux, tr, 16, LLEN, closure=cl)
    st_p, g_p = cohort.cohort_advance_reference(st, aux, tr, 16, LLEN,
                                                closure=cl)
    if nodes == 1:
        _equal(st_k, st_p, "16-round state")
        _equal(g_k, g_p, "16-round deposits")
    else:
        _close(g_k, g_p, 2e-5, 1e-5, "16-round deposits")
    k = cohort.ROUNDS_PER_LAUNCH if nodes == 1 else 1
    assert cohort.cohort_round_launches[key] == n0 + 1 + len(
        cohort.launch_rounds(16, k))


@pytest.mark.cuda
@pytest.mark.parametrize("name", VARIANTS)
def test_closure_variant_autograd_on_card(name):
    """run_cohort on the card with each closure variant carries a graph
    (DiffableCohort: the variant's kernel forward, the plain rounds
    backward): on tests/test_grad_closures.py's problem at 48 x 40 (the
    real fluvial rules, exact zeros around a band), the gradient of
    sum(G^2) w.r.t. the velocity field is finite, nonzero and equal to the
    plain rounds' own autograd gradient at rtol 1e-5 / atol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cohort kernel has no CPU mode")
    cl = CLOSURES[name]
    rules = erosion.make_fluvial_rules(ErosionParams(), 0.1)
    key = cohort.launch_key("fluvial", cl.nodes,
                            cohort.kernel_variant(cl, cl.nodes).tag)

    def grad(solve):
        v = (0.4 * torch.ones((48, 40), device="cuda")).requires_grad_(True)
        st, aux = band_problem(cl, v)
        G = solve(st, aux)
        return G.detach(), torch.autograd.grad((G * G).sum(), v)[0]

    n0 = cohort.cohort_round_launches.get(key, 0)
    G, got = grad(lambda s, a: cohort.run_cohort(s, a, rules, 4, 0.1, cl))
    assert cohort.cohort_round_launches[key] > n0
    G_p, want = grad(lambda s, a: cohort.cohort_advance_reference(
        s, a, rules, 4, 0.1, closure=cl)[1])
    assert bool(torch.isfinite(want).all()) and float(want.abs().max()) > 0
    _close(G, G_p, 2e-5, 1e-5, "deposits")
    _close(got, want, 1e-5, 1e-5, "velocity gradient")


# ---------------------------------------------------------------------------
# The particle estimators (their trajectory loop: csrc/particle_rounds.cu)
# and the host utilities on the card (no kernel of their own: plain torch
# on CUDA tensors)
# ---------------------------------------------------------------------------


def _round_case(kind, N, maxage, seed, W=256, H=256, scale=None, **kw):
    """The trajectory loop's inputs (`particle_round_inputs`) on the card:
    the flagship's parameters (examples/erosion.py `make_param`, a 20 km
    world) with N particles and `maxage`, or ErosionParams() with `kw`
    set when `scale` is given; a seeded state and seeded births."""
    from soillib_tpu_torch.examples.erosion import make_param
    from soillib_tpu_torch.testing import (
        birth_draws,
        particle_round_inputs,
        particle_state_fields,
    )

    p = make_param() if scale is None else ErosionParams()
    p.transportMethod, p.nSamples, p.maxage = "particles", N, maxage
    for k, v in kw.items():
        setattr(p, k, v)
    scale = scale or (20.0 / W, 20.0 / H, 4.0)
    return particle_round_inputs(kind, particle_state_fields(W, H, seed),
                                 scale, p, "cuda",
                                 birth_draws(N, 1, seed + 1)[0])


def _flux_pair(args):
    """(kernel flux, plain-loop flux) on the same CUDA tensors."""
    got = erosion._particle_rounds(**args)
    want = erosion._particle_rounds_plain(**args)
    torch.cuda.synchronize()
    return got, want


def _same_bits(got, want, msg):
    assert got.shape == want.shape, msg
    assert torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32)), msg


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fluvial", "debris"])
@pytest.mark.parametrize("maxage", [16, 256])
def test_particle_kernel_one_particle_bitwise_on_card(kind, maxage):
    """One particle a launch: its deposits land in program order, so the
    flux is the plain loop's bit for bit, at 15 and 255 rounds, for eight
    seeded births (most of them cross several cells)."""
    _needs_card()
    from soillib_tpu_torch.ops import particles

    launches = dict(particles.particle_launches)
    moved = 0
    for seed in range(8):
        got, want = _flux_pair(_round_case(kind, 1, maxage, seed))
        _same_bits(got, want, f"{kind} seed {seed}")
        moved += int((want[0] != 0).sum()) > 1
    assert moved >= 4
    assert particles.particle_launches[kind] == launches[kind] + 8


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fluvial", "debris"])
def test_particle_kernel_matches_plain_at_the_flagship_on_card(kind):
    """The flagship's 8192 particles at 15 rounds: per cell at rtol 2e-5
    and atol 1e-6 of each channel's largest finite magnitude (the atomics
    add in another order than the plain scatter), non-finite cells in the
    same places; the live particle-rounds counted are at most N x
    rounds."""
    _needs_card()
    from soillib_tpu_torch.ops import particles

    args = _round_case(kind, 8192, 16, 5)
    before = particles.particle_rounds()[kind]
    got, want = _flux_pair(args)
    live = particles.particle_rounds()[kind] - before
    assert 0 < live <= 8192 * 15
    for c in range(want.shape[0]):
        g, w = got[c].cpu().numpy(), want[c].cpu().numpy()
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, f"channel {c}")
        np.testing.assert_allclose(
            g[fin], w[fin], rtol=2e-5,
            atol=1e-6 * float(np.abs(w[fin]).max(initial=0.0)),
            err_msg=f"{kind} channel {c}")
    assert float(want[0].abs().max()) > 0.0


@pytest.mark.cuda
def test_particle_kernel_nonfinite_debris_on_card():
    """The debris mass factor that grows to inf (no yield stress, a fast
    suspension rate; the CPU test's inputs): inf and NaN in the same
    cells as the plain loop's, the finite cells per cell."""
    _needs_card()
    args = _round_case("debris", 512, 16, 8, W=20, H=24,
                       scale=(0.1, 0.1, 4.0), yieldStress=0.0,
                       suspensionRateDebris=5.0)
    got, want = (t[0].cpu().numpy() for t in _flux_pair(args))
    assert np.isinf(want).any()
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(
        got[fin], want[fin], rtol=2e-5,
        atol=1e-6 * float(np.abs(want[fin]).max(initial=0.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fluvial", "debris"])
def test_particle_kernel_deterministic_on_card(kind):
    """Under torch.use_deterministic_algorithms the kernel runs a round a
    launch and adds its log with the deterministic index_add_: the plain
    loop's flux bit for bit at the flagship's 8192 particles (the plain
    scatter is deterministic there too), and the particles' tensors left
    as they were."""
    _needs_card()
    from soillib_tpu_torch.ops import particles

    args = _round_case(kind, 8192, 16, 6)
    before = {k: v.clone() for k, v in args.items()
              if isinstance(v, torch.Tensor)}
    launches = particles.particle_launches[kind]
    torch.use_deterministic_algorithms(True)
    try:
        got, want = _flux_pair(args)
    finally:
        torch.use_deterministic_algorithms(False)
    _same_bits(got, want, kind)
    assert particles.particle_launches[kind] == launches + 15
    for k, v in before.items():
        assert torch.equal(args[k], v), k


@pytest.mark.cuda
def test_particle_kernel_counters_on_card():
    """A captured particle step launches the kernel twice a replay (one
    launch an estimator; the warm-up's launches are not counted), and the
    kernel counts its live particle-rounds on the card, eager, warm-up and
    replayed launches alike: at most N x rounds a launch, a replay's count
    the eager step's from the same state and seed. A field step launches
    it not at all and counts nothing."""
    _needs_card()
    from soillib_tpu_torch.core.device import seeded_generator
    from soillib_tpu_torch.models import simulation
    from soillib_tpu_torch.ops import particles

    p, state, scale = _compiled_config("particles")
    most = p.nSamples * (p.maxage - 1)

    def counts():
        return dict(particles.particle_launches), particles.particle_rounds()

    l0, r0 = counts()
    simulation.erode_step(simulation._canonicalize(state, p), scale, p,
                          seeded_generator("cuda", 5))
    l1, r1 = counts()
    fn = soil.make_erode_fn(p, scale, 1)
    fn(state, seeded_generator("cuda", 5))   # warm-up, capture, a replay
    l2, r2 = counts()
    fn(state, seeded_generator("cuda", 5))
    l3, r3 = counts()
    for k in ("fluvial", "debris"):
        assert l1[k] - l0[k] == 1 and l2[k] - l1[k] == 1
        assert l3[k] - l2[k] == 1
        eager = r1[k] - r0[k]
        assert 0 < eager <= most
        assert r3[k] - r2[k] == eager
        assert 0 < r2[k] - r1[k] - eager <= most
    particles.reset_particle_rounds()
    assert particles.particle_rounds() == dict.fromkeys(l3, 0)
    simulation._compiled.clear()
    p, state, scale = _compiled_config("default")
    soil.make_erode_fn(p, scale, 1)(state)
    torch.cuda.synchronize()
    assert counts() == (l3, dict.fromkeys(l3, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("maxage", [16, 256])
def test_particle_step_on_card_equals_the_cpu(maxage):
    """The same injected births on the card and the CPU: per cell at the
    CPU tests' bar (rtol 2e-5, atol 1e-6 of each field's largest finite
    magnitude) at 15 rounds; at the full 255 rounds, where a last-bit
    difference can move a particle to another cell, each field's total
    at rtol 1e-4 (of the sum of magnitudes). The debris albedo times the
    debris mass."""
    _needs_card()
    from soillib_tpu_torch.testing import (
        birth_draws,
        flagship_particle_step,
        particle_state_fields,
    )

    fields = particle_state_fields(256, 256, 5)
    draws = birth_draws(8192, 2, 6)
    card = flagship_particle_step(fields, "cuda", maxage, draws)
    cpu = flagship_particle_step(fields, "cpu", maxage, draws)
    assert card.layers.device.type == "cuda"
    for k, v in vars(cpu).items():
        want, got = v.numpy(), getattr(card, k).cpu().numpy()
        if k == "albedo_debris":
            # A ratio of deposits: the albedo mass it stands for, as the
            # CPU tests compare it.
            want, got = want * cpu.debris.numpy(), \
                got * card.debris.cpu().numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=k)
        if maxage <= 16:
            np.testing.assert_allclose(
                got, want, rtol=2e-5,
                atol=1e-6 * float(np.abs(want[fin]).max(initial=0.0)),
                err_msg=k)
        else:
            mag = float(np.abs(want[fin].astype(np.float64)).sum())
            np.testing.assert_allclose(
                got[fin].astype(np.float64).sum(),
                want[fin].astype(np.float64).sum(), rtol=1e-4,
                atol=1e-4 * mag, err_msg=k)


@pytest.mark.cuda
def test_particle_generators_live_on_the_card():
    _needs_card()
    from soillib_tpu_torch.core.device import seeded_generator

    p = ErosionParams()
    p.transportMethod, p.nSamples, p.maxage = "particles", 1024, 16
    sim = soil.ErosionSim((32, 32), (0.1, 0.1, 4.0), p, seed=3)
    assert sim.key.device.type == "cuda"
    assert bool(torch.isfinite(sim.step().height).all())
    with pytest.raises(ValueError, match="generator"):
        soil.erode(sim.state, (0.1, 0.1, 4.0), p,
                   key=seeded_generator("cpu"))
    flow = torch.randn(24, 16, 2, device="cuda")
    ones = torch.ones(24, 16, device="cuda")
    a = soil.solve_uniform(flow, ones, ones * 0.1, method="particles",
                           seed=2, offset=1)
    b = soil.solve_uniform(flow, ones, ones * 0.1, method="particles",
                           seed=2, offset=1)
    assert a.device.type == "cuda" and bool(torch.isfinite(a).all())
    _close(a, b, 1e-5, 1e-6 * float(a.abs().max()), "same stream")


@pytest.mark.cuda
def test_prefetch_on_card_streams_in_order():
    _needs_card()
    items = [(f"t{i}", np.full((64, 48), i, np.float32)) for i in range(7)]
    got = list(soil.prefetch(iter(items), depth=3))
    assert [n for n, _ in got] == [n for n, _ in items]
    for (_, a), (_, want) in zip(got, items):
        assert a.device.type == "cuda" and a.dtype == torch.float32
        np.testing.assert_array_equal(a.cpu().numpy(), want)
    sums = [float((a * 2.0).sum()) for _, a in
            soil.prefetch(iter(items), depth=1)]
    assert sums == [2.0 * i * 64 * 48 for i in range(7)]


@pytest.mark.cuda
def test_checkpoint_on_card_round_trip(tmp_path):
    _needs_card()
    from soillib_tpu_torch.io.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    h = torch.rand(64, 48, device="cuda")
    st = soil.ErosionState.zeros((64, 48), height=h, rainfall=2.0)
    save_checkpoint(str(tmp_path), st, 7)
    back = load_checkpoint(str(tmp_path), st, 7)
    on_cpu = load_checkpoint(str(tmp_path), st, 7, device="cpu")
    for k, v in vars(st).items():
        assert getattr(back, k).device.type == "cuda", k
        assert torch.equal(getattr(back, k), v), k
        assert torch.equal(getattr(on_cpu, k), v.cpu()), k


# ---------------------------------------------------------------------------
# Sharded execution (soillib_tpu_torch.parallel) on the card
# ---------------------------------------------------------------------------


def _sharded_cases(nprocs, transport, cases):
    """Rank 0's results of tests/torch_parallel_ranks.py `run_cases` on
    `nprocs` ranks sharing card 0."""
    from soillib_tpu_torch import parallel as par
    from tests import torch_parallel_ranks as ranks

    return par.launch(ranks.run_cases, nprocs, transport=transport,
                      devices=["cuda:0"] * nprocs, args=(cases,),
                      timeout=600)[0]


def _step_fields(n, seed=0):
    from soillib_tpu_torch.convert import state_to_numpy

    h = 2.0 + 0.02 * np.random.default_rng(seed).normal(size=(n, n))
    return state_to_numpy(soil.ErosionState.zeros(
        (n, n), height=torch.from_numpy(h.astype(np.float32)),
        device="cpu"))


def _step_params(**kw):
    p = ErosionParams()
    p.transportIterations = 32
    for k, v in kw.items():
        setattr(p, k, v)
    return p.freeze()


@pytest.mark.cuda
def test_sharded_step_one_rank_nccl_equals_erode_on_card():
    """A 1 x 1 mesh over NCCL (the group, the adaptive exit's all_reduce)
    runs erode's step bitwise on the card, at 32 rounds and with
    transportTol 1e-6 at the default depth."""
    _needs_card()
    fields = _step_fields(256)
    scale = (0.08, 0.08, 4.0)
    got = _sharded_cases(1, "nccl", [
        ("fixed", "erode", dict(fields=fields, frozen=_step_params(),
                                scale=scale, steps=1)),
        ("tol", "erode", dict(fields=fields, frozen=_step_params(
            transportIterations=0, transportTol=1e-6), scale=scale,
            steps=1))])
    for name in ("fixed", "tol"):
        assert got[name]["transport"] == "nccl"
        for f, a in got[name]["got"].items():
            np.testing.assert_array_equal(a.view(np.int32),
                                          got[name]["single"][f].view(
                                              np.int32), err_msg=f)


@pytest.mark.cuda
def test_sharded_step_four_ranks_share_the_card():
    """2 x 2 ranks on the one card over host-staged gloo: one 256^2 step
    within tests/test_parallel.py's bar (rtol 1e-4, atol 1e-5) of the
    single-device step on the card."""
    _needs_card()
    got = _sharded_cases(4, "gloo", [
        ("step", "erode", dict(fields=_step_fields(256, 1),
                               frozen=_step_params(),
                               scale=(0.08, 0.08, 4.0), steps=1))])["step"]
    assert got["transport"] == "gloo, host-staged"
    for f in ("layers", "discharge", "mass", "momentum", "debris",
              "debris_momentum", "albedo_surface"):
        np.testing.assert_allclose(got["got"][f], got["single"][f],
                                   rtol=1e-4, atol=1e-5, err_msg=f)


@pytest.mark.cuda
def test_sharded_accumulate_on_card():
    """The distributed accumulate (the tile kernels per block) on 2 x 2
    ranks sharing the card, against the single-device accumulate on the
    card at rtol 1e-5 / atol 1e-4."""
    _needs_card()
    rng = np.random.default_rng(4)
    h = (rng.normal(size=(512, 384)) * 3.0
         + np.linspace(0, 5, 512)[:, None]).astype(np.float32)
    h = soil.fill_depressions(torch.from_numpy(h), device="cpu")
    flows = {e: soil.steepest(h, e).numpy() for e in (soil.d4, soil.d8)}
    rain = np.ones((512, 384), np.float32)
    decay = np.full((512, 384), 0.98, np.float32)
    got = _sharded_cases(4, "gloo", [
        ("acc", "accumulate", dict(flows=flows, rain=rain, decay=decay))])
    for e, flow in flows.items():
        f = torch.from_numpy(flow).cuda()
        want = soil.accumulate(f, torch.from_numpy(rain).cuda(), e)
        _close(torch.from_numpy(got["acc"][f"plain{e}"]), want, 1e-5, 1e-4,
               f"edge {e}")
        want = soil.accumulate_decay(f, torch.from_numpy(rain).cuda(),
                                     torch.from_numpy(decay).cuda(), e)
        _close(torch.from_numpy(got["acc"][f"decay{e}"]), want, 1e-5, 1e-4,
               f"decay edge {e}")


@pytest.mark.cuda
def test_nccl_with_two_ranks_on_one_card_raises():
    """An impossible request raises before any rank starts; nothing falls
    back to gloo or to the CPU."""
    _needs_card()
    from soillib_tpu_torch import parallel as par
    from tests import torch_parallel_ranks as ranks

    with pytest.raises(ValueError, match="one card per rank"):
        par.launch(ranks.run_cases, 2, transport="nccl",
                   devices=["cuda:0", "cuda:0"], args=([],))
    with pytest.raises(ValueError, match="does not exist"):
        par.launch(ranks.run_cases, 1, transport="nccl",
                   devices=[f"cuda:{torch.cuda.device_count()}"], args=([],))


# ---------------------------------------------------------------------------
# The compiled driver: make_erode_fn, erode and ErosionSim replay one step
# captured as a CUDA graph (core/graphs.py CapturedStep)
# ---------------------------------------------------------------------------


def _compiled_config(name):
    """(params, state, scale) of a 256^2 step: the default step at 32
    rounds, field-static, the particle step, the adaptive exit at the
    default depth and CohortClosure(nodes=4)."""
    from soillib_tpu_torch.models import simulation

    simulation._compiled.clear()
    p = ErosionParams()
    p.transportIterations = 32
    p.trackAlbedo = True
    if name == "field-static":
        p.transportMethod = "field-static"
    elif name == "particles":
        p.transportMethod = "particles"
        p.nSamples = 8192
        p.maxage = 64
    elif name == "tol":
        p.transportIterations = 0
        p.transportTol = TOL
    elif name == "nodes4":
        p.transportIterations = 8
        p.closure = soil.CohortClosure(nodes=4)
    rng = np.random.default_rng(21)
    x = np.linspace(0, 6, 256)[:, None]
    y = np.linspace(0, 5, 256)[None, :]
    h = (2.0 + 0.3 * np.sin(x) * np.cos(y)
         + 0.01 * rng.normal(size=(256, 256))).astype(np.float32)
    state = soil.ErosionState.zeros((256, 256), height=torch.from_numpy(h)
                                    .cuda())
    return p, state, (0.1, 0.1, 4.0)


def _bitwise_states(a, b, what):
    from soillib_tpu_torch.models import simulation

    for f in simulation.FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32)), f"{what}: {f}"


def _counts():
    from soillib_tpu_torch.core.graphs import launch_counters

    return {k: dict(v) for k, v in zip(
        ("launches", "rounds", "sweep", "sweep_rounds", "tile",
         "particles"), launch_counters())}


def _diff(a, b):
    return {k: {n: a[k].get(n, 0) - b[k].get(n, 0) for n in a[k]
                if a[k].get(n, 0) != b[k].get(n, 0)} for k in a}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "field-static", "particles",
                                  "tol", "nodes4"])
def test_compiled_step_is_bitwise_the_eager_step_on_card(name):
    """Two steps replayed from the captured step against two eager
    `erode_step`s from the same state and seed: every field bit for bit,
    the kernels' launch counters advanced per replay by what the eager
    steps launch, and the particle generator left where the eager steps
    leave it. The particle step runs under
    torch.use_deterministic_algorithms on both paths: its trajectory
    kernel adds its deposits with atomics otherwise, so two eager steps
    differ in the last bits."""
    _needs_card()
    torch.use_deterministic_algorithms(name == "particles")
    try:
        _compiled_vs_eager(name)
    finally:
        torch.use_deterministic_algorithms(False)


def _compiled_vs_eager(name):
    from soillib_tpu_torch.core.device import seeded_generator
    from soillib_tpu_torch.models import simulation

    p, state, scale = _compiled_config(name)
    c0 = _counts()
    key = seeded_generator("cuda", 5)
    eager = simulation._canonicalize(state, p)
    for _ in range(2):
        eager = simulation.erode_step(eager, scale, p, key)
    torch.cuda.synchronize()
    c1 = _counts()
    gen = seeded_generator("cuda", 5)
    fn = soil.make_erode_fn(p, scale, 2)
    got = fn(state, gen)
    torch.cuda.synchronize()
    c2 = _counts()
    _bitwise_states(got, eager, name)
    assert _diff(c2, c1) == _diff(c1, c0)
    assert any(_diff(c1, c0)["launches"].values()) or name == "particles"
    if name == "field-static":
        assert _diff(c1, c0)["sweep"]["round"] > 0
    if name == "particles":
        assert torch.equal(gen.get_state(), key.get_state())
    (step,) = simulation._compiled.values()
    assert step.graph is not None
    # Two more replays from the returned state: the eager steps 3 and 4.
    again = fn(got, gen)
    eager = simulation.erode_step(simulation.erode_step(eager, scale, p, key),
                                  scale, p, key)
    _bitwise_states(again, eager, f"{name}, steps 3-4")


@pytest.mark.cuda
def test_compiled_step_with_a_host_read_raises_on_card(monkeypatch):
    """A host read inside the step cannot be captured: the call raises
    with the cause and does not run the step eagerly instead."""
    _needs_card()
    from soillib_tpu_torch.models import simulation

    p, state, scale = _compiled_config("default")
    creep = simulation.mass_creep
    calls = []

    def reads_the_host(delta, *a, **kw):
        calls.append(float(delta.abs().sum()))  # a device-to-host read
        return creep(delta, *a, **kw)

    monkeypatch.setattr(simulation, "mass_creep", reads_the_host)
    c0 = _counts()
    with pytest.raises(RuntimeError):
        soil.make_erode_fn(p, scale, 1)(state)
    assert len(calls) == 1  # the warm-up's read; the capture's raised
    assert not simulation._compiled
    assert _counts() == c0  # nothing counted for the step that never ran
    monkeypatch.undo()
    out = soil.make_erode_fn(p, scale, 1)(state)  # a new capture works
    assert bool(torch.isfinite(out.layers).all())


@pytest.mark.cuda
def test_compiled_driver_gradients_are_the_eager_steps_on_card():
    """A state that requires grad runs the eager step: gradients through
    make_erode_fn equal those through erode_step (rtol 1e-5: the
    backward's scatters add with atomics)."""
    _needs_card()
    from soillib_tpu_torch.models import simulation

    p, state, scale = _compiled_config("default")
    p.transportIterations = 8

    def grad(run):
        h = state.layers.clone().requires_grad_(True)
        out = run(state.replace(layers=h))
        out.discharge.sum().backward()
        return h.grad

    g = grad(lambda s: soil.make_erode_fn(p, scale, 2)(s))
    assert not simulation._compiled
    want = grad(lambda s: simulation.erode_step(simulation.erode_step(
        simulation._canonicalize(s, p), scale, p), scale, p))
    _close(g, want, 1e-5, 1e-6 * float(want.abs().max()), "gradient")
    assert float(g.abs().sum()) > 0.0


# ---------------------------------------------------------------------------
# The study harnesses (soillib_tpu_torch.benchmarks) on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_parity_field_half_kernels_match_plain_on_card(monkeypatch):
    """The parity harness at 48^2 (steep, 2 seeds, cold and warm, one
    coupled step x 2): the JAX harness's keys, finite metrics, and each
    eager field solve it ran (kernel 1) bitwise equal to the plain rounds
    on the same inputs."""
    _needs_card()
    from soillib_tpu_torch.benchmarks import parity as pp

    run = cohort.run_cohort
    solves = []

    def spy(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
        out = run(st0, aux, rules, iters, Llen, closure, tol)
        if not torch.cuda.is_current_stream_capturing():
            solves.append((cohort.as_stack(st0).clone(),
                           cohort.as_stack(aux).clone(), rules, iters, Llen,
                           closure, tol, out.clone()))
        return out

    monkeypatch.setattr(cohort, "run_cohort", spy)
    n0 = dict(cohort.cohort_round_launches)
    report = pp.run(pp.parse_args(["--size", "48", "--terrains", "steep",
                                   "--seeds", "2", "--steps", "1",
                                   "--maxage", "32"]), n_rep=2,
                    log=lambda s: None)
    monkeypatch.undo()
    assert pp.key_paths(report) == pp.key_paths(pp.report_skeleton(["steep"]))
    for path in pp.key_paths(report):
        v = report
        for k in path:
            v = v[k]
        assert np.isfinite(v), path
    for kind in ("fluvial", "debris"):
        assert cohort.cohort_round_launches[kind] > n0.get(kind, 0)
    assert len(solves) >= 4
    for st, aux, rules, iters, Llen, closure, tol, got in solves:
        _, want = cohort.cohort_advance_reference(st, aux, rules, iters, Llen,
                                                  closure=closure, tol=tol)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.cpu().numpy().view(np.int32))


@pytest.mark.cuda
def test_scaling_two_ranks_share_the_card_bitwise():
    """The weak-scaling harness's timed step on 2 ranks sharing the card
    (host-staged gloo), gathered, equals the single-device eager step on
    the same 128 x 256 grid bitwise; kernel 1 ran in every rank."""
    _needs_card()
    from soillib_tpu_torch import parallel as par
    from soillib_tpu_torch.benchmarks import scaling
    from soillib_tpu_torch.core.device import seeded_generator
    from soillib_tpu_torch.models import simulation

    rate, res = scaling.measure(2, 128, 1, 8, "gloo", ["cuda:0"] * 2,
                                keep=True)
    assert rate > 0.0
    for r in res:
        assert r["launches"]["fluvial"] > 0 and r["launches"]["debris"] > 0
    got = scaling.global_state(res, par.factor2(2))
    state, scale, param = scaling.problem(128, 256, 8, "cuda")
    state = simulation._canonicalize(state, param)
    key = seeded_generator("cuda", 0)
    for _ in range(2):
        state = simulation.erode_step(state, scale, param, key)
    for name in simulation.FIELDS:
        want = getattr(state, name).cpu().numpy()
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      want.view(np.int32), err_msg=name)
