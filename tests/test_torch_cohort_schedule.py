"""The cohort kernel path's plain parts, on the CPU: how `cohort_advance_cuda`
splits a solve into launches (`launch_rounds`), the launch geometry the
wrapper computes and hands to the kernel (`kernel_geometry`), and what the
wrapper refuses. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch.models.params import ErosionParams
from soillib_tpu_torch.ops import cohort
from tests.test_torch_cuda import (
    CASES,
    CLOSURES,
    LLEN,
    TOL,
    cohort_arrays,
    plain_exit_round,
    port_rules,
)

torch.set_num_threads(1)

K = cohort.ROUNDS_PER_LAUNCH
EVERY = cohort.TOL_CHECK_ROUNDS
SOURCE = (Path(__file__).resolve().parent.parent / "soillib_tpu_torch" /
          "csrc" / "cohort_round.cu")


def test_rounds_per_launch_divides_the_check_interval():
    assert K in (1, 2, 4, 8, 16) and EVERY % K == 0


@pytest.mark.parametrize("k", [1, K])
@pytest.mark.parametrize("iters", [1, 2, 15, 16, 17, 33, 35, 510])
def test_launch_rounds_split(iters, k):
    """The launches' rounds sum to iters, none exceeds k, and every
    multiple of TOL_CHECK_ROUNDS below iters is a launch boundary."""
    split = cohort.launch_rounds(iters, k)
    assert sum(split) == iters
    assert all(1 <= n <= k for n in split)
    bounds = set(np.cumsum([0] + split).tolist())
    assert set(range(0, iters, EVERY)) <= bounds
    # Only the launch before a boundary or the last may run short.
    assert len(split) == sum(-(-min(EVERY, iters - b) // k)
                             for b in range(0, iters, EVERY))


def _carried(kind, albedo):
    return (7 if albedo else 4) if kind == "fluvial" else (6 if albedo else 3)


@pytest.mark.parametrize("nodes", [1, 2, 4])
@pytest.mark.parametrize("kind,albedo", CASES)
def test_every_launch_fits_a_block(kind, albedo, nodes):
    """Every geometry the wrapper can launch (each rule set, albedo on and
    off, each node count and node rule, each rounds per launch) fits one
    block of the H100: 227 KB of shared memory and 1024 threads; an N-node
    cluster is at most 8 blocks (the portable size)."""
    C = _carried(kind, albedo)
    rules = ["face"] + {2: ["speed"], 4: ["sign", "cluster"]}.get(nodes, [])
    for rounds in (range(1, K + 1) if nodes == 1 else [1]):
        for rule in rules:
            g = cohort.kernel_geometry(C, nodes, 4096, 4096, rounds, rule)
            assert g.smem <= cohort.MAX_SHARED_BYTES == 232_448
            assert g.block[0] * g.block[1] <= 1024
            assert g.cluster <= 8 and g.grid[1] % g.cluster == 0
            assert g.rounds == rounds


def test_geometry_mirrors_the_kernel_source():
    """The wrapper's constants are the kernel file's (which refuses any
    other geometry), and so are its shared-memory formulas."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("K1") == K
    assert (const("RX1"), const("RY1")) == cohort.ONE_NODE_BLOCK
    assert (const("BXN"), const("BYN")) == cohort.NODES_BLOCK
    assert const("CLN") == cohort.NODES_CLUSTER
    assert const("XG") == cohort.EXCHANGE_CHANNELS
    assert "(8 * XG + 4 + Rules<KIND, ALBEDO>::C) * NT1" in src
    assert "((NSTATE + C) * (FACES + 2) + C) * NTN" in src
    assert "constexpr int FACES = RULE == SIGN ? 8 : 4;" in src


@pytest.mark.parametrize("nodes", [1, 4])
@pytest.mark.parametrize("W,H", [(1, 1), (20, 28), (21, 29), (62, 30),
                                 (4097, 33), (4096, 4096)])
def test_grid_covers_the_domain(W, H, nodes):
    """The grid's owned cells cover W x H with no block (or cluster) that
    owns none of it."""
    g = cohort.kernel_geometry(7, nodes, W, H)
    cols, rows = g.block
    own_y = cols - 2 * g.ring
    own_x = g.cluster * rows - 2 * g.ring
    clusters = g.grid[1] // g.cluster
    assert g.grid[0] * own_y >= H > (g.grid[0] - 1) * own_y
    assert clusters * own_x >= W > (clusters - 1) * own_x


@pytest.mark.parametrize("name,nodes,tag", [
    ("default", 1, ""), ("nodes4", 4, ""), ("legacy", 1, "legacy"),
    ("offstep-off", 1, "offstep=off"), ("stream", 1, "offstep=stream"),
    ("all-on", 1, "uniform,xmom,perstream"), ("sign", 4, "sign"),
    ("sign", 1, ""), ("cluster", 4, "cluster"), ("speed", 2, "speed")])
def test_kernel_variant_of_each_closure(name, nodes, tag):
    """Each closure names the kernel library built for it: the default
    physics with face routing (or any rule at one node, where no rule is
    read) the library built without defines, every other variant a
    library of its own, with -D defines, a file name and a launch key that
    name it; the variant code is the one csrc/cohort_round.cu's
    `cohort_variant` packs."""
    from soillib_tpu_torch import _native

    v = cohort.kernel_variant(CLOSURES[name], nodes)
    assert v.tag == tag
    assert (v.defines() == ()) == (tag == "")
    assert cohort.launch_key("fluvial", nodes, v.tag) == ",".join(
        ["fluvial"] + ([f"nodes={nodes}"] if nodes > 1 else [])
        + ([tag] if tag else []))
    if tag:
        assert len(v.defines()) == 6
        assert _native._target("cohort_round", v.defines()) != \
            _native._target("cohort_round")
    src = SOURCE.read_text()
    assert ("return (int)OFFSETS | OFFSTEP << 1 | (int)UNIFORM << 3 | "
            "(int)XMOM << 4 |\n         (int)PERSTREAM << 5 | RULE << 6;"
            in src)
    assert v.code == (int(v.offsets) | v.offstep << 1 | int(v.uniform) << 3
                      | int(v.xmom) << 4 | int(v.perstream) << 5
                      | ("face", "sign", "cluster", "speed").index(v.rule)
                      << 6)
    for d in v.defines():
        macro = d[2:].split("=")[0]
        assert f"#ifndef {macro}\n#define {macro} " in src


def test_wrapper_raises_on_cpu_tensors_and_bad_shapes():
    """The wrapper refuses what the kernel cannot take before launching
    anything: CPU tensors (even of the right shapes), a wrong channel
    count, grids that differ, rounds beyond a launch's, N-node launches
    of more than one round, other node counts and other rule sets."""
    W, H = 6, 5
    rules = port_rules("fluvial", False, W, H)
    st = torch.rand((14, W, H)) + 0.1
    aux = torch.ones((4, W, H))
    G = torch.zeros((4, W, H))
    before = dict(cohort.cohort_round_launches)
    with pytest.raises(ValueError, match="CUDA"):
        cohort.cohort_rounds_cuda(st, aux, G, rules, LLEN, K)
    with pytest.raises(ValueError, match=r"st must be \(14, W, H\)"):
        cohort.cohort_rounds_cuda(st[:13], aux, G, rules, LLEN)
    with pytest.raises(ValueError, match="one \\(W, H\\) grid"):
        cohort.cohort_rounds_cuda(st, aux[:, :5].contiguous(), G, rules,
                                  LLEN)
    with pytest.raises(ValueError, match="rounds"):
        cohort.cohort_rounds_cuda(st, aux, G, rules, LLEN, K + 1)
    with pytest.raises(ValueError, match="rounds"):
        cohort.cohort_rounds_cuda(st, aux, G, rules, LLEN, 0)
    st4 = torch.rand((56, W, H)) + 0.1
    with pytest.raises(ValueError, match="N-node launch runs 1 round"):
        cohort.cohort_rounds_cuda(st4, aux, G, rules, LLEN, 2, nodes=4)
    with pytest.raises(ValueError, match="nodes must be"):
        cohort.cohort_rounds_cuda(st, aux, G, rules, LLEN, nodes=3)
    st2 = torch.rand((28, W, H)) + 0.1
    for rule in ("sign", "cluster"):
        with pytest.raises(ValueError, match="requires nodes=4"):
            cohort.cohort_rounds_cuda(
                st2, aux, G, rules, LLEN, nodes=2,
                closure=soil.CohortClosure(node_rule=rule))
    with pytest.raises(ValueError, match="requires nodes=2"):
        cohort.cohort_rounds_cuda(
            st4, aux, G, rules, LLEN, nodes=4,
            closure=soil.CohortClosure(node_rule="speed"))

    class Other:
        kind = "other"

    with pytest.raises(NotImplementedError, match="fluvial and debris"):
        cohort.cohort_rounds_cuda(st, aux, G, Other(), LLEN)
    assert cohort.cohort_round_launches == before


class PlainLaunches:
    """Stands in for `cohort_rounds_cuda` on CPU tensors: runs each
    launch's rounds with the plain round (the kernel's arithmetic and
    order) and records (rounds, nodes) per launch."""

    def __init__(self):
        self.calls = []

    def __call__(self, st, aux, G, rules, Llen, rounds=1, out=None,
                 nodes=1, closure=None):
        self.calls.append((rounds, nodes))
        cl = dataclasses.replace(closure or soil.CohortClosure(),
                                 nodes=nodes, colors=1)
        for _ in range(rounds):
            st, G_new = cohort.cohort_round(st, G, aux, rules, Llen, cl)
            G.copy_(G_new)
        out.copy_(st)
        return out


@pytest.mark.parametrize("closure,iters,want", [
    (None, 35, [(K, 1)] * (34 // K) + [(1, 1)] * (1 + 34 % K)),
    (soil.CohortClosure(colors=2), 5, [(1, 1)] * 10),
    (soil.CohortClosure(nodes=2), 4, [(1, 2)] * 4),
    (soil.CohortClosure(offsets=False, offstep=False), 5,
     [(K, 1)] * (4 // K) + [(1, 1)] * (1 + 4 % K)),
    (soil.CohortClosure(nodes=4, node_rule="sign", colors=2), 3,
     [(1, 4)] * 6),
])
def test_advance_splits_launches(monkeypatch, closure, iters, want):
    """`cohort_advance_cuda`'s schedule with the plain round standing in
    for the kernel: one-node solves at ROUNDS_PER_LAUNCH rounds a launch,
    colored and N-node solves one round per launch and color group; the
    results are bitwise those of the plain solve."""
    cl = closure or soil.CohortClosure()
    groups = int(cl.colors) * int(cl.nodes)
    sts = [cohort_arrays("fluvial", True, 20, 18, seed=j)
           for j in range(groups)]
    st = torch.from_numpy(np.concatenate([s for s, _ in sts]))
    aux = torch.from_numpy(sts[0][1])
    tr = port_rules("fluvial", True, 20, 18)
    fake = PlainLaunches()
    monkeypatch.setattr(cohort, "cohort_rounds_cuda", fake)
    st_k, g_k = cohort.cohort_advance_cuda(st, aux, tr, iters, LLEN,
                                           closure=closure)
    assert fake.calls == want
    st_p, g_p = cohort.cohort_advance_reference(st, aux, tr, iters, LLEN,
                                                closure=closure)
    assert torch.equal(st_k, st_p) and torch.equal(g_k, g_p)


def test_advance_reads_the_exit_at_launch_boundaries(monkeypatch):
    """With `tol`, the exit is read before the launches that start at a
    multiple of TOL_CHECK_ROUNDS: the solve runs the plain exit round
    rounded up to the next check."""
    p = ErosionParams()
    p.evapRate = 50.0
    p.depositionRateFluvial = 50.0
    st, aux = cohort_arrays("fluvial", True, 48, 40, seed=3, aux3_scale=50.0)
    st, aux = torch.from_numpy(st), torch.from_numpy(aux)
    tr = port_rules("fluvial", True, 48, 40, p)
    iters = 88
    exit_plain = plain_exit_round(st, aux, tr, iters)
    assert 0 < exit_plain < iters // 2
    fake = PlainLaunches()
    monkeypatch.setattr(cohort, "cohort_rounds_cuda", fake)
    cohort.cohort_advance_cuda(st, aux, tr, iters, LLEN, tol=TOL)
    run = sum(r for r, _ in fake.calls)
    assert run == min(iters, -(-exit_plain // EVERY) * EVERY)
    assert fake.calls == [(n, 1) for n in cohort.launch_rounds(run, K)]
