"""The port's weak-scaling harness (`soillib_tpu_torch.benchmarks.scaling`,
the twin of `benchmarks/scaling.py`) on gloo CPU ranks spawned by
`parallel.launch`, at a tiny block: its lines carry the JAX harness's
keys, and the step it times equals the single-device step bitwise (one
torch thread in every process, as the ranks run). About 20 s.
"""

import json
import os

import numpy as np
import pytest
import torch

import soillib_tpu_torch as soil
from soillib_tpu_torch import parallel as par
from soillib_tpu_torch.benchmarks import scaling
from soillib_tpu_torch.convert import state_to_numpy
from soillib_tpu_torch.core.device import seeded_generator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The keys of the JAX harness's lines (benchmarks/scaling.py `main`).
JAX_KEYS = ["devices", "cell_steps_per_s", "per_device",
            "weak_scaling_efficiency"]
BLOCK, STEPS, ITERS = 8, 1, 4


def test_jax_harness_prints_these_keys():
    with open(os.path.join(REPO, "benchmarks", "scaling.py")) as f:
        src = f.read()
    for k in JAX_KEYS:
        assert f'"{k}":' in src, k


def test_virtual_ranks_print_one_line_per_mesh(capsys):
    lines = scaling.main(["--virtual", "4", "--block", str(BLOCK),
                          "--steps", str(STEPS), "--iters", str(ITERS)])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [ln["devices"] for ln in lines] == [1, 2, 4]
    for ln in lines:
        assert list(ln) == JAX_KEYS
        assert ln["cell_steps_per_s"] > 0.0
        # Both rounded to 0.1 as the JAX harness rounds them.
        assert abs(ln["per_device"]
                   - ln["cell_steps_per_s"] / ln["devices"]) <= 0.1
    assert lines[0]["weak_scaling_efficiency"] == 1.0


def test_timed_step_equals_the_single_device_step_bitwise():
    """The 2 x 2 mesh's timed call (its second, from the first's result)
    gathered to the global grid, against `make_erode_fn` run twice on the
    same 16^2 problem in one process."""
    rate, results = scaling.measure(4, BLOCK, STEPS, ITERS, "gloo",
                                    ["cpu"] * 4, keep=True)
    assert rate > 0.0 and all(r["seconds"] > 0.0 for r in results)
    assert all(r["launches"] == {} for r in results)  # no kernel on the CPU
    got = scaling.global_state(results, par.factor2(4))

    n = 2 * BLOCK
    state, scale, param = scaling.problem(n, n, ITERS, "cpu")
    fn = soil.make_erode_fn(param, scale, steps=STEPS)
    key = seeded_generator("cpu", 0)
    want = state_to_numpy(fn(fn(state, key), key))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      w.view(np.int32), err_msg=name)
    assert float(np.abs(want["discharge"]).max()) > 0.0


@pytest.mark.parametrize("flags", [["--procs", "1,2"], []])
def test_card_modes_need_a_card(flags, monkeypatch):
    """--procs and the one-card-a-rank mode raise without a card: no CPU
    fallback (--virtual runs on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.main(flags)
