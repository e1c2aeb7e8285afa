"""The port's headline bench (soillib_tpu_torch/bench.py) and its FP32
probe's plain chains (soillib_tpu_torch/ops/fp32_chain.py) on the CPU,
against the JAX package's bench.py: the byte model, the constant
operation tables of the default closure and of each closure variant
(recomputed from the JAX jaxpr per weight class, so a drift of the JAX
package shows here), the port's own dispatch count, the
JSON line of `main --device cpu`, and the plain chains."""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from soillib_tpu_torch import bench
from soillib_tpu_torch.ops import cohort, fp32_chain
from soillib_tpu_torch.testing import CLOSURES, VARIANTS


def test_byte_model_matches_jax_bench():
    """K = 16 rounds per pass is the JAX kernel's K at 4096^2 with albedo
    on, so the two models agree there: 1488 B per cell-step at 32
    rounds, and at the auto bound (510 rounds)."""
    assert bench.step_bytes_per_cell(32, True) == 1488.0
    for iters in (32, 510):
        assert bench.step_bytes_per_cell(iters, True) == float(
            jax_bench.step_bytes_per_cell(iters, True, (4096, 4096)))


@pytest.mark.parametrize("albedo_on", [True, False])
def test_op_table_matches_jax_jaxpr_counts(albedo_on):
    """ROUND_OPS per weight class = bench.cohort_round_ops with that
    class's weight at 1 and the others at 0."""
    zero = dict.fromkeys(("exp", "div", "sqrt"), 0.0)
    base = jax_bench.cohort_round_ops(zero, albedo_on)
    per_class = {k: [base[k]] for k in base}
    for cls in ("exp", "div", "sqrt"):
        counts = jax_bench.cohort_round_ops({**zero, cls: 1.0}, albedo_on)
        for k in counts:
            per_class[k].append(counts[k] - base[k])
    for kind in ("fluvial", "debris"):
        np.testing.assert_allclose(bench.ROUND_OPS[(kind, albedo_on)],
                                   per_class[kind], rtol=1e-9)
    costs = {"exp": 4.0, "div": 9.0, "sqrt": 6.5}
    want = jax_bench.cohort_round_ops(costs, albedo_on)
    got = bench.round_ops(costs, albedo_on)
    for kind in ("fluvial", "debris"):
        assert got[kind] == pytest.approx(want[kind], rel=1e-9)


def _variant_cases():
    """(closure name, rule kind, nodes, kernel variant tag) of every solve
    a closure variant changes: the node rules reach the fluvial solve
    only."""
    out = []
    for name in VARIANTS:
        cl = CLOSURES[name]
        for kind in ("fluvial",) if cl.nodes > 1 else ("fluvial", "debris"):
            out.append((name, kind, cl.nodes,
                        cohort.kernel_variant(cl, cl.nodes).tag))
    return out


@pytest.mark.parametrize("name,kind,nodes,tag", _variant_cases())
def test_variant_op_table_matches_jax_jaxpr_counts(name, kind, nodes, tag):
    """VARIANT_ROUND_OPS per weight class = the JAX bench's count
    (`_count_ops`) of the JAX round under the closure, on the same
    counting inputs as `cohort_round_ops` (ones on 8 x 128, default
    parameters, albedo on, Llen 0.11), each class's weight at 1 in turn;
    and `closure_round_ops` weighs the row by the costs."""
    from soillib_tpu.models.erosion import make_debris_rules, \
        make_fluvial_rules
    from soillib_tpu.models.params import ErosionParams
    from soillib_tpu.ops import cohort as jax_cohort

    W, H, Llen = 8, 128, 0.11
    p = ErosionParams()
    p.trackAlbedo = True
    rules = (make_fluvial_rules(p, Llen) if kind == "fluvial"
             else make_debris_rules(p, Llen, 1.0))
    C = 7 if kind == "fluvial" else 6
    cl = jax_cohort.CohortClosure(**dataclasses.asdict(CLOSURES[name]))
    jaxpr = jax.make_jaxpr(lambda st, G, aux: jax_cohort.cohort_round(
        st, G, aux, rules, Llen, jax_cohort.shift_push, cl))(
        jnp.ones((nodes * (jax_cohort.NSTATE + C), W, H)),
        jnp.zeros((C, W, H)), jnp.ones((4, W, H)))
    zero = dict.fromkeys(("exp", "div", "sqrt"), 0.0)

    def count(costs):
        return jax_bench._count_ops(jaxpr.jaxpr, costs, W * H) / (W * H)

    base = count(zero)
    want = [base] + [count({**zero, c: 1.0}) - base
                     for c in ("exp", "div", "sqrt")]
    np.testing.assert_allclose(
        bench.VARIANT_ROUND_OPS[(kind, True, nodes, tag)], want, rtol=1e-9)
    costs = {"exp": 4.0, "div": 9.0, "sqrt": 6.5}
    assert bench.closure_round_ops(costs, kind, True, nodes, tag) == (
        pytest.approx(count(costs), rel=1e-9))


def test_variant_op_table_has_a_row_for_each_variant_solve():
    assert sorted(bench.VARIANT_ROUND_OPS) == sorted(
        (kind, True, nodes, tag) for _, kind, nodes, tag in _variant_cases())
    costs = {"exp": 4.0, "div": 9.0, "sqrt": 6.5}
    assert bench.closure_round_ops(costs, "fluvial", True, 4) == (
        4 * bench.round_ops(costs)["fluvial"])


@pytest.mark.parametrize("albedo_on", [True, False])
def test_port_dispatch_count_near_the_table(albedo_on):
    """The port's own plain round, counted by dispatch on bench.py's
    counting inputs, stays within 10% of the reference's count with unit
    weights."""
    port = bench.port_round_ops(albedo_on)
    for kind in ("fluvial", "debris"):
        ref = sum(bench.ROUND_OPS[(kind, albedo_on)])
        got = sum(port[kind].values())
        assert abs(got - ref) <= 0.1 * ref, (kind, got, ref)
        assert port[kind]["exp"] > 0 and port[kind]["div"] > 0
        assert port[kind]["sqrt"] > 0


def test_main_on_cpu_prints_one_json_line():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = bench.main(["--size", "32", "--iters", "4", "--steps", "2",
                          "--device", "cpu"])
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == out
    assert set(line) == {
        "metric", "value", "unit", "vs_baseline", "hbm_sol", "compute_sol",
        "bw_bytes_per_s", "bytes_per_cell_step", "fp32_ops_per_s",
        "fp32_ops_per_cell_step", "device"}
    assert list(line) == list(bench.JSON_KEYS)
    assert line["unit"] == "gridpoint-steps/s" and line["device"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["bytes_per_cell_step"] == bench.step_bytes_per_cell(4, True)
    # One pass of each cohort solve at 4 rounds.
    assert line["bytes_per_cell_step"] == 344 + 320 + 160


def _fma_exact(y, a, b):
    """float32 fma(y, a, b) with one rounding (exact rational sum)."""
    from fractions import Fraction

    out = np.empty_like(y)
    for i, v in enumerate(y):
        out[i] = np.float32(float(Fraction(float(v)) * Fraction(float(a))
                                  + Fraction(float(b))))
    return out


@pytest.mark.parametrize("op", fp32_chain.OPS)
def test_plain_chains_short_form(op):
    """The plain chains at 4 rounds against a numpy float32 evaluation of
    the same K chains (fma with a single rounding), rtol 1e-6."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0.25, 1.0, 64).astype(np.float32)
    got = fp32_chain.chain(torch.from_numpy(x), op, 4).numpy()
    a, a2, b = np.float32(1.0000001), np.float32(0.9999999), np.float32(1e-9)
    ys = [x * np.float32(1.0 + 0.001 * k) for k in range(fp32_chain.K)]
    for _ in range(4 * fp32_chain.U):
        for k, y in enumerate(ys):
            if op == "fma":
                ys[k] = _fma_exact(y, a, b)
            elif op == "fma2":
                ys[k] = _fma_exact(_fma_exact(y, a, b), a2, b)
            elif op == "exp":
                ys[k] = np.exp(-y) + np.float32(0.1)
            elif op == "div":
                ys[k] = np.float32(1.5) / (y + np.float32(1.0))
            else:
                ys[k] = np.sqrt(y + np.float32(0.25))
    want = ys[0]
    for y in ys[1:]:
        want = want + y
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert fp32_chain.ops_per_launch(64, 4) == 64 * 4 * 16 * 4


def test_chain_refuses_cpu_tensors_in_the_kernel_wrapper():
    """The kernel wrapper takes CUDA tensors only; the CPU path is the
    plain chains."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        fp32_chain.chain_cuda(torch.ones(8), "fma", 1)
    with pytest.raises(ValueError, match="unknown op"):
        fp32_chain.chain(torch.ones(8), "log", 1)
