"""A run with the timed path broken underneath comes out not correct, and
so does the control (the reference in bfloat16 put in the program's
place): on the CPU at 32 x 32, the look for a card skipped, with the
cells' own limits."""

import pytest
import torch

from perfbench import check, run, spec
from perfbench.reference import step as reference


def _unchanged(step):
    def fault(state, scale, param, key=None, **kw):
        step(state, scale, param, key, **kw)  # the births still advance
        return state
    return fault


def _half_left_out(step):
    def fault(state, scale, param, key=None, **kw):
        out = step(state, scale, param, key, **kw)
        kw_out = {}
        for f in reference.FIELDS:
            new, old = getattr(out, f), getattr(state, f)
            if new.shape == old.shape and new.shape[-1] > 1:
                new = new.clone()
                H = new.shape[-1]
                new[..., H // 2:] = old[..., H // 2:]
            kw_out[f] = new
        return out.replace(**kw_out)
    return fault


def _altered(step):
    def fault(state, scale, param, key=None, **kw):
        out = step(state, scale, param, key, **kw)
        d = out.discharge.clone()
        k = int(torch.argmax(d.abs()))
        d.view(-1)[k] *= 1.05
        return out.replace(discharge=d)
    return fault


def _albedo_white(step):
    """The step with its albedo arithmetic skipped: every albedo it
    returns is white, as the configurations' inputs are."""
    def fault(state, scale, param, key=None, **kw):
        out = step(state, scale, param, key, **kw)
        return out.replace(**{f: torch.ones_like(getattr(out, f))
                              for f in ("albedo_surface", "albedo_fluvial",
                                        "albedo_debris")})
    return fault


@pytest.mark.parametrize("method", ["field", "particles"])
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered,
                                   _albedo_white])
def test_broken_step_is_not_correct(tiny, monkeypatch, method, fault):
    from soillib_tpu_torch.models import simulation

    here, bench = tiny
    monkeypatch.setattr(simulation, "erode_step",
                        fault(simulation.erode_step))
    cell = spec.cell(bench, f"tiny.{method}")
    out = run.run_cell(cell, bench, 2**31 + 5, 0.2, False, device="cpu",
                       here=here)
    assert out["correct"] is False and out["failed"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("method", ["field", "particles"])
def test_sound_run_is_correct_and_its_line_has_the_keys(tiny, method):
    here, bench = tiny
    cell = spec.cell(bench, f"tiny.{method}")
    out = run.run_cell(cell, bench, 2**31 + 5, 0.2, False, device="cpu",
                       here=here)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert list(out["checks"]) == ["surface", "fluvial", "debris",
                                   "passthrough"]
    assert set(out["metrics"]) == {"cell_steps_per_s.small", "peak_mem_gb",
                                   "setup_s"}
    assert out["attempted"] >= 1
    # The first step, the two sampled from the window and the albedo step.
    assert len(out["info"]["steps_checked"]) == 4
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}


@pytest.mark.parametrize("cell_name", ["erosion-4096.field32",
                                       "erosion-256.particles",
                                       "erosion-256.field64",
                                       "erosion-4096.auto"])
def test_control_is_not_correct(tiny, cell_name):
    """The bfloat16 reference against the float32 one, from the tiny
    cell's state after its first step, fails the real cell's limits."""
    here, bench = tiny
    method = ("particles" if "particles" in cell_name else "field")
    cell = spec.cell(bench, f"tiny.{method}")
    cfg = spec.config(cell["config"], here)
    trf = spec.traffic(cell["traffic"], here)
    pipe = spec.pipeline(spec.pipeline_name(cfg), here).Pipeline(
        cfg, trf, 11, "cpu")
    fields = pipe.inputs()
    ref = pipe.reference(fields, 0)
    ctrl = pipe.control(fields, 0)
    nums = pipe.numbers(pipe.gaps(fields, ctrl, ref))
    lim = spec.limits(cell_name)["limits"]
    assert check.judge(nums, lim), nums


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "erosion-256.field64", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
