"""The plain reference against the program's eager step at 32 x 32 on the
CPU: the field solve and the particle estimators with the same births.
(The test imports both; the reference itself imports nothing of the
program.)"""

import pytest
import torch

from perfbench import spec, terrain
from perfbench.reference import rng, step as reference


@pytest.mark.parametrize("method", ["field", "particles"])
def test_reference_equals_the_eager_step(tiny, method):
    import soillib_tpu_torch as soil
    from soillib_tpu_torch.core.device import seeded_generator
    from soillib_tpu_torch.models.simulation import _canonicalize, erode_step

    here, bench = tiny
    cell = spec.cell(bench, f"tiny.{method}")
    cfg = spec.config(cell["config"], here)
    trf = spec.traffic(cell["traffic"], here)
    seed = 2**31 + 77
    mod = spec.pipeline(spec.pipeline_name(cfg), here)
    pipe = mod.Pipeline(cfg, trf, seed, "cpu")
    p, scale = pipe.p, pipe.scale
    param = mod.program_params(soil, p)
    state = _canonicalize(soil.ErosionState(**pipe.inputs()), param)
    key = seeded_generator("cpu", terrain.sim_seed(seed))
    gen = rng.generator("cpu", terrain.sim_seed(seed))
    for i in range(3):
        out = erode_step(state, scale, param, key)
        inp = {f: getattr(state, f) for f in reference.FIELDS}
        ref = reference.erode_step(inp, scale, p, gen)
        prog = {f: getattr(out, f) for f in reference.FIELDS}
        nums = pipe.numbers(pipe.gaps(inp, prog, ref))
        assert max(nums.values()) <= 1e-6, (i, nums)
        assert nums["fluvial"] == 0.0 or method == "particles"
        state = out


def test_births_follow_the_seed():
    g = rng.generator("cpu", 12345)
    a = reference.births(8, 8, 64, g, torch.zeros(()))
    reference.skip_births(64, g, "cpu", 2)
    g2 = rng.generator("cpu", 12345)
    reference.skip_births(64, g2, "cpu", 0)
    b = reference.births(8, 8, 64, g2, torch.zeros(()))
    assert torch.equal(a[2], b[2])
