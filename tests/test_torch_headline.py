"""The port's headline artifacts have one source of truth: README.md's
port table must equal a regeneration from the bench lines in
soillib_tpu_torch/benchmarks/headline/ (`results_table.py --check`, the
twin of tests/test_results_consistency.py), and each line must be what
the port's bench prints for its configuration (`headline.CONFIGS`): the
bench's keys, the card it ran on, the yardstick of its configuration,
and the three added keys consistent with it. CPU only; no JAX needed.
"""

import json
import os
import re
import shutil

import pytest

from soillib_tpu_torch import bench
from soillib_tpu_torch.benchmarks import headline, results_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HEADLINE = os.path.join(REPO, "benchmarks", "headline")
NAMES = sorted(headline.CONFIGS)
ADDED = ("label", "ms_per_step", "note")


def _line(name):
    with open(os.path.join(headline.HEADLINE, f"{name}.json")) as f:
        return json.load(f)


def test_results_table_check_passes_on_the_committed_files(capsys):
    assert results_table.main(["--check"]) == 0, capsys.readouterr().err


@pytest.fixture
def copies(tmp_path, monkeypatch):
    """A copy of the headline directory and of README.md under tmp_path,
    which results_table reads in their place."""
    d = tmp_path / "headline"
    shutil.copytree(headline.HEADLINE, d)
    readme = tmp_path / "README.md"
    shutil.copy(results_table.README, readme)
    monkeypatch.setattr(results_table, "HEADLINE", str(d))
    monkeypatch.setattr(results_table, "README", str(readme))
    return d, readme


@pytest.mark.parametrize("target", NAMES + ["README.md"])
def test_a_one_character_edit_makes_check_fail(copies, target, capsys):
    d, readme = copies
    assert results_table.main(["--check"]) == 0
    if target == "README.md":
        path = readme
        text = path.read_text()
        # The first digit of the table's first row.
        i = text.index("\n", text.index("|---|", text.index(
            results_table.START)))
        i += re.search(r"\d", text[i:]).start()
    else:
        path = d / f"{target}.json"
        text = path.read_text()
        # The first digit of the bench's value.
        i = text.index('"value": ') + len('"value": ')
    assert text[i].isdigit()
    edited = text[:i] + ("2" if text[i] == "1" else "1") + text[i + 1:]
    path.write_text(edited)
    assert results_table.main(["--check"]) == 1
    assert "STALE" in capsys.readouterr().err


def test_the_file_names_are_the_jax_headline_names():
    def names(d):
        return sorted(f for f in os.listdir(d) if f.endswith(".json"))

    assert names(headline.HEADLINE) == names(JAX_HEADLINE)
    assert [f"{n}.json" for n in NAMES] == names(JAX_HEADLINE)


@pytest.mark.parametrize("name", NAMES)
def test_the_bench_keys_are_what_the_bench_prints(name):
    d = _line(name)
    assert list(d)[-len(ADDED):] == list(ADDED)
    assert list(d)[:-len(ADDED)] == list(bench.JSON_KEYS)


@pytest.mark.parametrize("name", NAMES)
def test_the_labels_are_the_jax_labels(name):
    with open(os.path.join(JAX_HEADLINE, f"{name}.json")) as f:
        assert _line(name)["label"] == json.load(f)["label"]


@pytest.mark.parametrize("name", NAMES)
def test_device_names_an_nvidia_card_and_a_power_limit(name):
    assert re.fullmatch(r"NVIDIA [^,]+, \d+(\.\d+)? W", _line(name)["device"])


@pytest.mark.parametrize("name", NAMES)
def test_ms_per_step_agrees_with_value_and_size(name):
    d, cfg = _line(name), headline.config_of(name)
    n = cfg["size"]
    assert f"@{n}x{n}," in d["metric"]
    assert d["ms_per_step"] == round(n * n / d["value"] * 1e3, 1)
    assert d["value"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_bytes_per_cell_step_is_the_yardstick_of_the_configuration(name):
    d, cfg = _line(name), headline.config_of(name)
    iters = 510 if cfg["iters"] == "auto" else int(cfg["iters"])
    assert d["bytes_per_cell_step"] == bench.step_bytes_per_cell(
        iters, cfg["albedo"])
    depth = "auto(<=510)" if cfg["iters"] == "auto" else cfg["iters"]
    assert d["metric"].endswith(f", {depth} transport rounds")


@pytest.mark.parametrize("name", NAMES)
def test_the_note_holds_the_command(name):
    assert _line(name)["note"].split(";")[0] == headline.command(name)
