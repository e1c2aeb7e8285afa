"""Eight plain cohort rounds of every CohortClosure variant of the port
(`cohort_advance_reference`) against the JAX package's, on the CPU: the
ten closures of tests/test_grad_closures.py, fluvial and debris. One
round of each, the refusals and the erode steps are in
tests/test_torch_closures.py.

The JAX side runs eagerly (jax.disable_jit), as tests/test_grad_closures.py
runs it. Deposits are held at the JAX package's multi-round bar, rtol
2e-5 / atol 1e-5 (f32 reassociation noise grows through the nonlinear
rounds). The debris states carry physical debris masses (1e-3 of the
seeded O(1) carried mass): the debris rules are not contractive, and at
O(1) masses on this small grid the carried mass grows to the 1e30 clip
within a few rounds, where f32 noise is no longer comparable.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soillib_tpu.ops import cohort as jax_cohort
from soillib_tpu_torch.ops import cohort as port_cohort
from tests.test_torch_cohort import _problem
from tests.test_torch_cuda import CLOSURES, LLEN, closure_state

torch.set_num_threads(1)

W, H = 32, 24
ROUNDS = 8


@pytest.mark.parametrize("name", list(CLOSURES))
@pytest.mark.parametrize("kind", ["fluvial", "debris"])
def test_cohort_advance_variant_matches_jax(kind, name):
    cl = CLOSURES[name]
    st, aux = closure_state(kind, True, cl, W, H, seed=2,
                            mass_scale=1.0 if kind == "fluvial" else 1e-3)
    _, _, (jr, tr) = _problem(kind, True, W, H)
    with jax.disable_jit():
        _, jg = jax_cohort.cohort_advance_reference(
            jnp.asarray(st), jnp.asarray(aux), jr, ROUNDS, LLEN,
            closure=jax_cohort.CohortClosure(**dataclasses.asdict(cl)))
    _, tg = port_cohort.cohort_advance_reference(
        torch.from_numpy(st), torch.from_numpy(aux), tr, ROUNDS, LLEN,
        closure=cl)
    assert float(np.abs(np.asarray(jg)).max()) > 0.0
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-5,
                               atol=1e-5, err_msg="deposits")
